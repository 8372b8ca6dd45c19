"""What a run is handed, made from the configuration, the traffic and the
seed: the box of hexes, its mesh arrays and the initial state.

The benchmark makes these itself and gives the same to the program and to
the reference.  The mesh arrays are those of the program's two hex
generators (periodic box, and the channel with walls at its y faces:
hifiles_tpu_torch/mesh/generate.py), made in bulk with numpy.  The state
is the configuration's initial condition plus a smooth velocity
perturbation drawn from the seed: a few Fourier modes of every velocity
component, with wavenumbers up to ``max_wavenumber``, each with a non-zero
z wavenumber so that no mode changes a plane's mass flux, in a channel
faded to zero at the walls, and each component scaled to an RMS over the
solution points of exactly ``amplitude`` times the flow's reference
velocity.  Every seed gives the same sizes, the same work and the same
perturbation energy: the seed moves the modes' shapes only.
"""

from __future__ import annotations

import numpy as np

from .reference.fr_hex import Box

MAX_V, MAX_F = 27, 6


def box_of(config: dict) -> Box:
    """The configuration's box of hexes."""
    m = config["mesh"]
    return Box(m["n"], m["lo"], m["hi"], m["walls"])


def mesh_arrays(box: Box) -> dict:
    """The program's MeshData fields for ``box`` but the element type (all
    hexahedra): vertices, cells (c2v slot i + 2j + 4k of a cell's
    corners), boundary groups ("Cyclic" on periodic faces, "Wall" on the y
    faces of a channel; local faces 0 z-, 1 y-, 2 x+, 3 y+, 4 x-, 5 z+)."""
    nx, ny, nz = box.n
    xs, ys, zs = (np.linspace(box.lo[d], box.hi[d], box.n[d] + 1)
                  for d in range(3))
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    xv = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    k, j, i = (a.ravel() for a in np.meshgrid(np.arange(nz), np.arange(ny),
                                              np.arange(nx), indexing="ij"))
    vid = lambda i, j, k: (k * (ny + 1) + j) * (nx + 1) + i
    C = nx * ny * nz
    c2v = -np.ones((C, MAX_V), dtype=np.int64)
    for s in range(8):
        c2v[:, s] = vid(i + (s & 1), j + ((s >> 1) & 1), k + ((s >> 2) & 1))
    bc_id = -np.ones((C, MAX_F), dtype=np.int64)
    wall = 1 if box.walls else 0
    for face, on in ((0, k == 0), (1, j == 0), (2, i == nx - 1),
                     (3, j == ny - 1), (4, i == 0), (5, k == nz - 1)):
        bc_id[on, face] = wall if face in (1, 3) else 0
    return dict(n_dims=3, xv=xv, c2v=c2v, c2n_v=np.full(C, 8, np.int64),
                bc_id=bc_id,
                bc_names=["Cyclic", "Wall"] if box.walls else ["Cyclic"],
                ic2icg=np.arange(C, dtype=np.int64))


def positions(box: Box, nodes) -> list:
    """x, y, z of every solution point, each broadcastable to the state's
    (Ez, Ey, Ex, kz, ky, kx) axes."""
    c = [box.coords(d, nodes) for d in range(3)]
    return [c[0][None, None, :, None, None, :],
            c[1][None, :, None, None, :, None],
            c[2][:, None, None, :, None, None]]


def initial_state(config: dict, traffic: dict, phys: dict, box: Box,
                  nodes, seed: int) -> np.ndarray:
    """The initial state (5, Ez, Ey, Ex, kz, ky, kx) in float64."""
    x, y, z = positions(box, nodes)
    shape = np.broadcast_shapes(x.shape, y.shape, z.shape)
    gam = phys["gamma"]
    if config["initial"] == "taylor_green":
        # the TGV (HiFiLES ic_form 7)
        V0 = phys["V0"]
        p = (phys["p_ic"] + phys["rho_ic"] * V0 ** 2 / 16.0
             * (np.cos(2 * x) + np.cos(2 * y)) * (np.cos(2 * z) + 2.0))
        rho = p / (phys["R"] * phys["T_ic"])
        vel = [V0 * np.sin(x) * np.cos(y) * np.cos(z),
               -V0 * np.cos(x) * np.sin(y) * np.cos(z), 0.0 * z]
        v_ref = V0
    elif config["initial"] == "uniform":
        # a uniform stream (HiFiLES ic_form 1)
        rho, p = phys["rho_ic"], phys["p_ic"]
        vel = [np.full(shape, v) for v in phys["vel_ic"]]
        v_ref = float(np.linalg.norm(phys["vel_ic"]))
    else:
        raise ValueError(f"initial condition {config['initial']!r}")
    rho, p = np.broadcast_to(rho, shape), np.broadcast_to(p, shape)
    vel = [np.broadcast_to(v, shape) + v_ref * dv
           for v, dv in zip(vel, perturbation(traffic["perturbation"], box,
                                              (x, y, z), shape, seed))]
    u = np.empty((5,) + shape)
    u[0] = rho
    for m in range(3):
        u[1 + m] = rho * vel[m]
    u[4] = p / (gam - 1.0) + 0.5 * rho * sum(v * v for v in vel)
    return u


def perturbation(spec: dict, box: Box, xyz, shape, seed: int) -> list:
    """The seeded velocity perturbation, one array per component."""
    rng = np.random.default_rng(seed)
    K, n_modes = spec["max_wavenumber"], spec["modes"]
    phase = [2 * np.pi * (c - box.lo[d]) / (box.hi[d] - box.lo[d])
             for d, c in enumerate(xyz)]
    fade = 1.0
    if box.walls:
        fade = np.sin(np.pi * (xyz[1] - box.lo[1]) / (box.hi[1] - box.lo[1]))
    out = []
    for _ in range(3):
        dv = np.zeros(shape)
        for _ in range(n_modes):
            kx, ky = rng.integers(-K, K + 1, size=2)
            kz = rng.integers(1, K + 1) * rng.choice([-1, 1])
            if box.walls:
                ky = 0
            a, phi = rng.normal(), rng.uniform(0.0, 2 * np.pi)
            dv += a * np.cos(kx * phase[0] + ky * phase[1] + kz * phase[2]
                             + phi)
        dv = dv * fade
        out.append(spec["amplitude"] * dv / np.sqrt(np.mean(dv * dv)))
    return out
