"""The PyTorch port's copies of the JAX package's numpy host layers (config,
mesh, ops, native) build exactly what the JAX modules build: every array
field is compared with np.array_equal, every other field with ==."""

import dataclasses
import glob
import os

import numpy as np
import pytest

import hifiles_tpu.config.params as jparams
import hifiles_tpu.mesh.generate as jgen
import hifiles_tpu.ops.operators as jops
from hifiles_tpu import native as jnative
from hifiles_tpu.mesh.core import build_faces as jax_build_faces
from hifiles_tpu.ops.les_filter import build_les_filter as jax_les_filter
from hifiles_tpu.ops.stabilization import build_exp_filter as jax_exp_filter
from hifiles_tpu.ops.stabilization import build_over_int_ops as jax_over_int

import hifiles_tpu_torch.config.params as tparams
import hifiles_tpu_torch.mesh.generate as tgen
import hifiles_tpu_torch.ops.operators as tops
from hifiles_tpu_torch import native as tnative
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.mesh.core import build_faces as port_build_faces
from hifiles_tpu_torch.ops.les_filter import build_les_filter
from hifiles_tpu_torch.ops.stabilization import (build_exp_filter,
                                                 build_over_int_ops)

DECKS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "decks",
                                      "input_*")))
TYPES = {"quad": 1, "hex": 4, "tri": 0, "tet": 2, "prism": 3}


def same(a, b, where=""):
    """a equals b: arrays by np.array_equal (dtype too), dataclasses and
    plain objects attribute by attribute, containers item by item."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
        return 1
    if dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        va, vb = vars(a), vars(b)
        assert va.keys() == vb.keys(), where
        return sum(same(va[k], vb[k], f"{where}.{k}") for k in va)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        return sum(same(x, y, f"{where}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        return sum(same(a[k], b[k], f"{where}[{k}]") for k in a)
    if isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
        return 0
    assert a == b, (where, a, b)
    return 0


def ops_of(mod, ctype, order):
    """One package's ElementOps with the deck defaults per element type."""
    p = jparams.RunInput()
    if ctype in ("quad", "hex"):
        key = "quad" if ctype == "quad" else "hexa"
        return mod.build_tensor_ops(TYPES[ctype], order,
                                    getattr(p, f"upts_type_{key}"),
                                    getattr(p, f"vcjh_scheme_{key}"),
                                    getattr(p, f"eta_{key}"))
    if ctype == "tri":
        return mod.build_tri_ops(order, p.upts_type_tri, p.fpts_type_tri,
                                 p.vcjh_scheme_tri, p.c_tri)
    if ctype == "tet":
        return mod.build_tet_ops(order, p.upts_type_tet, p.fpts_type_tet,
                                 p.vcjh_scheme_tet, p.c_tet)
    return mod.build_pri_ops(order, p.upts_type_pri_tri, p.upts_type_pri_1d,
                             p.vcjh_scheme_pri_1d, p.eta_pri,
                             p.vcjh_scheme_tri, p.c_tri)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_element_ops_identical(ctype, order):
    a, b = ops_of(jops, ctype, order), ops_of(tops, ctype, order)
    assert same(a, b, "ops") > 10


GENERATORS = {
    "periodic_quad_mesh": (3, 2, -1.0, 2.0, 0.0, 1.5),
    "channel_quad_mesh": (4, 3, 0.0, 2.0, 0.0, 1.0),
    "ywall_channel_quad_mesh": (4, 3, 0.0, 2.0, 0.0, 1.0),
    "periodic_mixed_mesh_2d": (4, 3),
    "channel_mixed_mesh_2d": (4, 4, 0.0, 2.0, 0.0, 1.0),
    "periodic_hex_mesh": (3, 2, 2),
    "periodic_tet_mesh": (2, 2, 3),
    "periodic_prism_mesh": (2, 3, 2),
    "channel_prism_tet_mesh": (2, 2, 2, 2),
    "channel_hex_mesh": (3, 2, 2),
    "periodic_curved_hex20_mesh": (2, 2, 2),
    "periodic_curved_prism15_mesh": (2, 2, 2),
}


def test_every_generator_is_covered():
    names = {n for n in dir(jgen) if n.endswith("_mesh")
             or n.endswith("_mesh_2d")}
    assert names == set(GENERATORS)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_mesh_generator_identical(name):
    args = GENERATORS[name]
    a = getattr(jgen, name)(*args)
    b = getattr(tgen, name)(*args)
    assert same(a, b, name) >= 5
    c = mesh_from(a)
    assert type(c) is type(b) and same(c, b, name) >= 5


@pytest.mark.parametrize("deck", DECKS, ids=os.path.basename)
def test_run_input_from_deck_identical(deck):
    a = jparams.RunInput.from_deck(deck)
    b = tparams.RunInput.from_deck(deck)
    c = run_input_from(a)
    assert type(c) is type(b)
    decks = [x._deck for x in (a, b, c)]
    a._deck = b._deck = c._deck = None
    same(a, b, os.path.basename(deck))
    same(c, b, os.path.basename(deck))
    for d in decks[1:]:
        assert d._lines == decks[0]._lines and d.name == decks[0].name
    assert [bc.flag for bc in a.bc_list] == [bc.flag for bc in b.bc_list]


def test_bc_flags_identical():
    flags = [n for n in dir(jparams) if n.isupper() and not n.startswith("_")]
    assert len(flags) > 10
    for n in flags:
        assert getattr(jparams, n) == getattr(tparams, n), n


FACE_MESHES = {
    "quad": lambda g: g.periodic_quad_mesh(4, 3),
    "tri_quad": lambda g: g.periodic_mixed_mesh_2d(4, 4),
    "hex_walls": lambda g: g.channel_hex_mesh(3, 2, 2),
    "tet": lambda g: g.periodic_tet_mesh(2, 2, 2),
    "prism_tet": lambda g: g.channel_prism_tet_mesh(2, 2, 2, 2),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mesh", sorted(FACE_MESHES))
def test_build_faces_identical(mesh, native, monkeypatch):
    """Face connectivity with the C++ kernel and with the numpy path
    (HIFILES_NO_NATIVE), JAX package against port, cyclic groups paired."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_lib", None)
    if not native:
        monkeypatch.setenv("HIFILES_NO_NATIVE", "1")
    ma, mb = FACE_MESHES[mesh](jgen), FACE_MESHES[mesh](tgen)
    flags = {i: (jparams.CYCLIC if n in ("Cyclic", "Cyc") else
                 jparams.ADIABAT_WALL) for i, n in enumerate(ma.bc_names)}
    lo = ma.xv.min(axis=0)
    dc = ma.xv.max(axis=0) - lo
    a = jax_build_faces(ma, flags, dc)
    b = port_build_faces(mb, flags, dc)
    assert tnative.available() == native
    assert same(a, b, mesh) >= 8


@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_filters_and_over_int_ops_identical(ctype):
    """build_les_filter (every filter type), build_exp_filter and
    build_over_int_ops of the port's copies on one type at p = 3."""
    a, b = ops_of(jops, ctype, 3), ops_of(tops, ctype, 3)
    for ft in (0, 1, 2, 3):
        assert np.array_equal(jax_les_filter(a, ft, 2.0),
                              build_les_filter(b, ft, 2.0)), ft
    assert np.array_equal(jax_exp_filter(a, 1.0, 16, 2),
                          build_exp_filter(b, 1.0, 16, 2))
    for q in (4, 5):
        same(jax_over_int(a, q), build_over_int_ops(b, q), f"over {q}")


GMSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
2 1 "FLUID"
1 2 "Wall"
$EndPhysicalNames
$Nodes
7
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
7 3 0.5 0
$Elements
6
1 3 2 1 1 1 2 5 4
2 3 2 1 1 2 3 6 5
3 2 2 1 1 3 7 6
4 1 2 2 2 1 2
5 1 2 2 2 2 3
6 1 2 2 2 3 7
$EndElements
"""


@pytest.mark.parametrize("mesh", ["quad", "hex_walls", "tet", "tri_quad",
                                  "hex20"])
def test_gambit_roundtrip_identical(mesh, tmp_path):
    """write_gambit of the JAX package and of the port write the same file,
    and read_gambit of both reads the same MeshData back."""
    import hifiles_tpu.mesh.gambit as jg
    import hifiles_tpu_torch.mesh.gambit as tg
    make = dict(FACE_MESHES,
                hex20=lambda g: g.periodic_curved_hex20_mesh(2, 2, 2))[mesh]
    a, b = str(tmp_path / "jax.neu"), str(tmp_path / "port.neu")
    jg.write_gambit(make(jgen), a)
    tg.write_gambit(make(tgen), b)
    assert open(a).read() == open(b).read()
    assert same(jg.read_gambit(a), tg.read_gambit(a), mesh) >= 5


def test_gmsh_reader_identical(tmp_path):
    """read_gmsh of both packages on a small quad + tri mesh with a wall
    group."""
    from hifiles_tpu.mesh.gmsh import read_gmsh as jax_read
    from hifiles_tpu_torch.mesh.gmsh import read_gmsh
    path = tmp_path / "strip.msh"
    path.write_text(GMSH)
    a, b = jax_read(str(path)), read_gmsh(str(path))
    assert a.n_cells == 3 and (a.bc_id >= 0).sum() == 3
    assert same(a, b, "gmsh") >= 5


# the meshes of tests/test_mixed_soa.py: the tri+quad box and the
# wall-modelled prism/tet channel, with over-integration geometry on the
# box (p=2 both)
MIXED_MESHES = {
    "tri_quad": (lambda g: g.periodic_mixed_mesh_2d(6, 6, -10, 10, -10, 10),
                 {0: jparams.CYCLIC}, 4),
    "prism_tet": (lambda g: g.channel_prism_tet_mesh(3, 2, 2, 2, x1=2.0,
                                                     y1=1.0, z1=1.0),
                  None, None),
}


def mixed_tables(gen, build_faces_fn, elements, ops_mod, case):
    """(mixed_type_selections, build_mixed_blocks) of one package."""
    make, flags, over = MIXED_MESHES[case]
    mesh = make(gen)
    if flags is None:
        flags = {i: (jparams.CYCLIC if n == "Cyclic" else
                     jparams.ADIABAT_WALL) for i, n in enumerate(mesh.bc_names)}
    lo = mesh.xv.min(axis=0)
    conn = build_faces_fn(mesh, flags, mesh.xv.max(axis=0) - lo)
    ops = {int(ct): ops_of(ops_mod, {v: k for k, v in TYPES.items()}[int(ct)],
                           2) for ct in np.unique(mesh.ctype)}
    return (elements.mixed_type_selections(mesh, conn),
            elements.build_mixed_blocks(mesh, conn, ops, over_int_order=over))


@pytest.mark.parametrize("case", sorted(MIXED_MESHES))
def test_mixed_tables_identical(case):
    """The port's copies of mixed_type_selections and build_mixed_blocks
    (its per-type blocks, global slot tables and geometry) against the JAX
    module's."""
    import hifiles_tpu.solver.elements as jel
    import hifiles_tpu_torch.solver.elements as tel
    sa, ta = mixed_tables(jgen, jax_build_faces, jel, jops, case)
    sb, tb = mixed_tables(tgen, port_build_faces, tel, tops, case)
    assert same(sa, sb, "sels") == len(sa) == 2
    assert same(ta, tb, "mixed") > 20


@pytest.mark.parametrize("case", sorted(MIXED_MESHES))
def test_mixed_flat_slot_tables_cover_each_slot_once(case):
    """The mixed residual's flat point tables: the interior pairs' two
    sides and the boundary points together list every global slot exactly
    once; each pair's points coincide up to a cyclic shift; the boundary
    points run face by face, each on its face."""
    import hifiles_tpu_torch.solver.elements as tel
    from hifiles_tpu_torch.solver.residual_mixed_soa import (
        MixedSoaTables, bdy_point_faces)
    _, mt = mixed_tables(tgen, port_build_faces, tel, tops, case)
    T = MixedSoaTables(mt)
    every = np.concatenate([T.slot_l, T.slot_r, T.slot_b.ravel()])
    assert np.array_equal(np.sort(every), np.arange(mt.n_slots))
    assert T.slot_l.shape == T.slot_r.shape and T.slot_b.shape[0] == 1
    gap = mt.pos_fpts[T.slot_l] - mt.pos_fpts[T.slot_r]
    period = np.ptp(mt.pos_fpts, axis=0)
    shift = np.round(gap / np.where(period > 0, period, 1.0))
    assert np.abs(gap - shift * period).max() < 1e-9
    nfp = {int(n) for n in (mt.int_mask > 0).sum(axis=1)}
    assert len(nfp) == 1 or case == "prism_tet"
    faces = bdy_point_faces(mt)
    assert faces.size == T.slot_b.size == (mt.bdy_mask > 0).sum()
    assert (faces.size > 0) == (case == "prism_tet")
    assert np.all(np.diff(faces) >= 0)
    assert (mt.bdy_slot[faces] == T.slot_b[0][:, None]).any(axis=1).all()


@pytest.mark.parametrize("mode", [0, 1])
def test_inlet_host_setup_identical(mode):
    """turb_inlet.inlet_host_setup (numpy, the eddy box, length scale,
    area weights and seeded initial eddies) on the SEM channel's block,
    field by field against the JAX package's."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_turb_inlet import les_channel_input
    from hifiles_tpu.solver.solver import Solver as JaxSolver
    from hifiles_tpu.solver.turb_inlet import inlet_host_setup as jax_setup
    import hifiles_tpu_torch
    from hifiles_tpu_torch.solver.turb_inlet import inlet_host_setup
    p = les_channel_input(inlet_type=2, n_eddy=16, mode=mode)
    mesh = jgen.channel_quad_mesh(6, 3, 0.0, 2.0, 0.0, 1.0)
    js = JaxSolver(p, mesh)
    ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                  device="cpu")
    a, b = jax_setup(p, js.block, 7), inlet_host_setup(ts.p, ts.block, 7)
    assert sorted(vars(a)) == sorted(vars(b))
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        else:
            assert v == w, k


# meshes of the partition copies (parallel/sharding.py)
SHARD_MESHES = {
    "hex": lambda g: g.periodic_hex_mesh(4, 4, 2),
    "quad_channel": lambda g: g.channel_quad_mesh(10, 4, 0.0, 2.0, 0.0, 1.0),
    "tet": lambda g: g.periodic_tet_mesh(2, 2, 2),
}


def shard_setup(gen, build_faces_fn, elements, ops_mod, case):
    """(connectivity, element block) of one package's SHARD_MESHES mesh,
    p=2."""
    mesh = SHARD_MESHES[case](gen)
    flags = {i: (jparams.CYCLIC if n == "Cyclic" else jparams.ADIABAT_WALL)
             for i, n in enumerate(mesh.bc_names)}
    conn = build_faces_fn(mesh, flags,
                          mesh.xv.max(axis=0) - mesh.xv.min(axis=0))
    name = {v: k for k, v in TYPES.items()}[int(mesh.ctype[0])]
    return conn, elements.build_element_block(mesh, conn,
                                              ops_of(ops_mod, name, 2))


@pytest.mark.parametrize("case", sorted(SHARD_MESHES))
def test_partitions_identical(case):
    """The contiguous, spectral and graph partitions and the
    Kernighan-Lin refinement (parallel/sharding.py:74-267), 3 and 5
    shards, against the JAX module's."""
    import hifiles_tpu.parallel.sharding as jsh
    import hifiles_tpu.solver.elements as jel
    import hifiles_tpu_torch.parallel.sharding as tsh
    import hifiles_tpu_torch.solver.elements as tel
    ca, _ = shard_setup(jgen, jax_build_faces, jel, jops, case)
    cb, _ = shard_setup(tgen, port_build_faces, tel, tops, case)
    E = int(max(ca.int_ele_l.max(), ca.int_ele_r.max())) + 1
    pairs = np.stack([ca.int_ele_l, ca.int_ele_r], axis=1)
    both = np.concatenate([pairs, pairs[:, ::-1]])
    both = both[np.argsort(both[:, 0], kind="stable")]
    xadj = np.concatenate([[0], np.cumsum(np.bincount(both[:, 0],
                                                      minlength=E))])
    for n in (3, 5):
        cont = jsh._contiguous_partition(E, n)
        same(cont, tsh._contiguous_partition(E, n), "contiguous")
        same(jsh._spectral_partition(ca, E, n),
             tsh._spectral_partition(cb, E, n), "spectral")
        same(jsh.graph_partition(ca, E, n), tsh.graph_partition(cb, E, n),
             "graph")
        same(jsh._refine_partition(xadj, both[:, 1], cont.copy(), n),
             tsh._refine_partition(xadj, both[:, 1], cont.copy(), n),
             "refine")
