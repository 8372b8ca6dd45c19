"""K3's source on the CPU: the per-point functions of hifiles_tpu_torch/
csrc/ldg_point.cuh (fpts_slot, upts_point, and the volume kernel's
point_flux they share) and its launch checks, compiled by g++ into a host
driver with the C entries of the CUDA library, each walking every point of
its launch as the kernel's threads do.  The wrapper's own argument structs
(ldg_element.launch_fpts, launch_upts) drive it.  Held against the plain
versions on every instantiation (d = 2 and 3, F = d+2 and d+3, SGS none,
Smagorinsky and WALE) and flag (Sutherland, added flux), in f32 and f64,
with broadcast, full and mixed geometry, with and without the gradient
output at the flux points.

The launches themselves run only on the card: chip_smoke.py holds the
kernels as nvcc builds them there."""

import ctypes
import dataclasses
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hifiles_tpu_torch.backend import CSRC
from hifiles_tpu_torch.solver import ldg_element as L
from hifiles_tpu_torch.solver import volume as V

torch.set_num_threads(1)

# the C entries of csrc/ldg_element.cu on the host: the same checks and
# instantiations (dispatch_physics), one point after another
HOST_DRIVER = r"""
#include "ldg_point.cuh"

namespace {

template <typename T>
struct Fpts {
  const HftFptsArgs* a;
  hft::Params<T> prm;
  int n;
  template <typename, int D, int F, int SGS>
  int run() const {
    for (int s = 0; s < n; ++s) hft::fpts_slot<T, D, F, SGS>(*a, prm, s);
    return 0;
  }
};

template <typename T>
int fpts(const HftFptsArgs* a, const HftVolumeArgs* p) {
  if (hft::fpts_refused(*a, *p)) return 1;
  return hft::dispatch_physics<T>(
      p->n_dims, p->n_fields, p->sgs,
      Fpts<T>{a, hft::params_of<T>(*p),
              hft::launch_points(a->n_eles, a->n_fpts)});
}

template <typename T>
int upts(const HftUptsArgs* a) {
  if (hft::upts_refused(*a)) return 1;
  const int n = hft::launch_points(a->n_upts, a->n_eles);
  for (int p = 0; p < n; ++p) {
    if (a->n_dims == 2) {
      hft::upts_point<T, 2>(*a, p);
    } else {
      hft::upts_point<T, 3>(*a, p);
    }
  }
  return 0;
}

}  // namespace

extern "C" {
int hft_ldg_fpts_f32(const HftFptsArgs* a, const HftVolumeArgs* p, int,
                     void*) {
  return fpts<float>(a, p);
}
int hft_ldg_fpts_f64(const HftFptsArgs* a, const HftVolumeArgs* p, int,
                     void*) {
  return fpts<double>(a, p);
}
int hft_ldg_upts_f32(const HftUptsArgs* a, int, void*) {
  return upts<float>(a);
}
int hft_ldg_upts_f64(const HftUptsArgs* a, int, void*) {
  return upts<double>(a);
}
}
"""


@pytest.fixture(autouse=True)
def zero_counters():
    yield
    V.reset_counters()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host driver built from K3's header."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("ldg_element_host")
    (d / "host_driver.cpp").write_text(HOST_DRIVER)
    lib = d / "libldg_element_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(lib), str(d / "host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    return L.bind_entries(ctypes.CDLL(str(lib)))


def entry(lib, name, dtype):
    return getattr(lib, f"hft_ldg_{name}_"
                   f"{'f32' if dtype == torch.float32 else 'f64'}")


def held(got, want, dtype, what):
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = max(want.abs().max().item(), 1.0)
    assert torch.isfinite(got).all(), what
    assert (got - want).abs().max().item() <= tol * scale, what


BASE = V.VolumeParams(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                      inviscid=False, rt_inf=1.0, c_sth=0.368,
                      prandtl_t=0.9, C_s=0.1, kappa=0.41)
# flux points per element of a hex (p = 1) and of a quad (p = 2); an odd
# element count
PF = {2: 12, 3: 24}
E_FPTS = 37


def fpts_operands(d, F, seed):
    """Seeded numpy operands at the flux points, in ranges where every
    branch of the physics is taken: tgf, u_f, jg, inv_det, norm, delta,
    wdist, extra."""
    rng = np.random.default_rng(seed)
    E, Pf = E_FPTS, PF[d]
    u = rng.random((F, E, Pf)) + 1.0
    u[d + 1] += 10.0
    if F == d + 3:
        u[d + 2] = BASE.mu * rng.uniform(-2.0, 20.0, (E, Pf))
    return dict(tgf=rng.normal(size=(d, F, E, Pf)) * 0.5, u_f=u,
                jg=rng.random((d, d, E, Pf)), inv_det=0.5 + rng.random((E, Pf)),
                norm=rng.normal(size=(d, E, Pf)),
                delta=0.5 + rng.random((E, Pf)),
                wdist=0.5 * rng.random((E, Pf)),
                extra=rng.normal(size=(d, F, E, Pf)) * 0.1)


# the geometry operands kept at one column ("full": none)
GEOMETRY = {"full": (), "broadcast": ("jg", "inv_det", "norm", "delta",
                                      "wdist"),
            # the channel's: the wall distance and the normals per element
            "mixed": ("jg", "inv_det", "delta")}


def fpts_call(ops, dtype, geo, add):
    t = {k: torch.tensor(a, dtype=dtype) for k, a in ops.items()}
    for k in GEOMETRY[geo]:
        t[k] = t[k][..., :1, :].contiguous()
    if not add:
        t["extra"] = None
    return t


@pytest.mark.parametrize("sgs", [V.SGS_NONE, V.SGS_SMAGORINSKY, V.SGS_WALE],
                         ids=["none", "smagorinsky", "wale"])
@pytest.mark.parametrize("sa", [False, True], ids=["ns", "sa"])
@pytest.mark.parametrize("d", [2, 3])
def test_ldg_fpts_source_matches_plain_version(host_kernel, d, sa, sgs):
    """K3 at the flux points, one instantiation: every flag, geometry,
    dtype, with and without the gradient output."""
    F = d + 2 + int(sa)
    ops = fpts_operands(d, F, 10 * d + 3 * sa + sgs)
    n = 0
    for fix_vis, add, dtype, geo, with_grad in itertools.product(
            (1, 0), (False, True), (torch.float32, torch.float64),
            sorted(GEOMETRY), (False, True)):
        prm = dataclasses.replace(BASE, fix_vis=fix_vis, sgs=sgs)
        t = fpts_call(ops, dtype, geo, add)
        args = [t[k] for k in ("tgf", "u_f", "jg", "inv_det", "norm")]
        rest = [t["delta"], t["wdist"], t["extra"]]
        assert L.check_fpts(*args, prm, *rest) == (d, F, E_FPTS, PF[d])
        qn = torch.full_like(t["u_f"], float("nan"))
        grad = torch.full_like(t["tgf"], float("nan")) if with_grad else None
        L.launch_fpts(entry(host_kernel, "fpts", dtype), *args, prm, *rest,
                      qn, grad, 0, None)
        want_qn, want_grad = L.flux_point_qn_ref(*args, prm, *rest,
                                                 with_grad=True)
        what = (fix_vis, add, dtype, geo, with_grad)
        held(qn, want_qn, dtype, what)
        if with_grad:
            held(grad, want_grad, dtype, what)
        # the CPU wrapper is the plain version
        got = L.flux_point_qn(*args, prm, *rest, with_grad=with_grad)
        assert torch.equal(got[0], want_qn)
        assert (got[1] is None) == (not with_grad)
        n += 1
    assert n == 48 and L.flux_point_qn.launches == 0


# solution-point shapes: (d, U, F, E)
UPTS = [(2, 9, 4, 130), (2, 6, 5, 37), (3, 8, 5, 37), (3, 27, 6, 20),
        (3, 4, 1, 7)]


@pytest.mark.parametrize("geo", ["full", "broadcast", "mixed"])
@pytest.mark.parametrize("shape", UPTS, ids=lambda s: "d{}U{}F{}E{}".format(
    *s))
def test_ldg_upts_source_matches_plain_version(host_kernel, shape, geo):
    """K3 at the solution points: jg and 1/det full or one column each
    ("mixed": jg full, 1/det one column), f32 and f64."""
    d, U, F, E = shape
    rng = np.random.default_rng(U * E + F)
    tg = rng.normal(size=(d, U, F, E))
    jg = rng.random((d, d, U, E))
    inv_det = 0.5 + rng.random((U, E))
    if geo == "broadcast":
        jg = jg[..., :1]
    if geo != "full":
        inv_det = inv_det[..., :1]
    for dtype in (torch.float32, torch.float64):
        t = [torch.tensor(np.ascontiguousarray(a), dtype=dtype)
             for a in (tg, jg, inv_det)]
        assert L.check_upts(*t) == (d, U, F, E)
        grad = torch.full_like(t[0], float("nan"))
        L.launch_upts(entry(host_kernel, "upts", dtype), *t, grad, 0, None)
        want = L.solution_point_gradient_ref(*t)
        held(grad, want, dtype, (shape, geo, dtype))
        assert torch.equal(L.solution_point_gradient(*t), want)


def test_ldg_source_refuses(host_kernel):
    """The launches the kernels refuse (the inviscid part on, an unknown
    SGS model, more points than an int counts, d = 4 at the solution
    points) raise, and the wrappers' checks refuse bad operands."""
    d, F = 3, 5
    t = fpts_call(fpts_operands(d, F, 0), torch.float64, "full", False)
    args = [t[k] for k in ("tgf", "u_f", "jg", "inv_det", "norm")]
    qn = torch.empty_like(t["u_f"])
    run = entry(host_kernel, "fpts", torch.float64)
    for prm in (dataclasses.replace(BASE, inviscid=True),
                dataclasses.replace(BASE, viscous=False),
                dataclasses.replace(BASE, sgs=5)):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            L.launch_fpts(run, *args, prm, t["delta"], t["wdist"], None, qn,
                          None, 0, None)
    a = L._FptsArgs(n_eles=2 ** 20, n_fpts=2 ** 12)
    phys = V.args_of(BASE, F, d, False)
    assert run(ctypes.byref(a), ctypes.byref(phys), 0, None) == 1
    b = L._UptsArgs(n_dims=4, n_upts=2, n_fields=5, n_eles=3)
    assert entry(host_kernel, "upts", torch.float64)(
        ctypes.byref(b), 0, None) == 1
    bad = [
        (dict(prm=dataclasses.replace(BASE, inviscid=True)), "viscous"),
        (dict(norm=t["norm"][:, :2]), "norm"),
        (dict(jg=t["jg"].transpose(2, 3)), "jg"),
        (dict(tgf=t["tgf"].float()), "device and dtype"),
        (dict(u_f=t["u_f"].transpose(1, 2).contiguous().transpose(1, 2)),
         "contiguous"),
        (dict(prm=dataclasses.replace(BASE, sgs=V.SGS_WALE), delta=None),
         "delta"),
    ]
    for change, match in bad:
        kw = dict(zip(("tgf", "u_f", "jg", "inv_det", "norm"), args),
                  prm=BASE)
        kw.update(change)
        with pytest.raises(ValueError, match=match):
            L.flux_point_qn(**kw)
    with pytest.raises(ValueError, match="inv_det"):
        L.solution_point_gradient(torch.zeros(3, 4, 5, 6),
                                  torch.zeros(3, 3, 4, 6),
                                  torch.zeros(4, 2))


def test_ldg_counters_follow_captured_replays():
    """K3's launch counters ride volume.captured_launches and count_replay
    as the volume kernel's do: a capture's launches come back as one
    replay's and leave the counters as they were; each replay adds
    them; reset_counters zeroes them."""
    f, g = L.flux_point_qn, L.solution_point_gradient

    def capture():
        for _ in range(5):
            f.launches += 1
            f.by_variant["D3F5+viscous"] += 1
            g.launches += 1
            g.by_variant["D3F5"] += 1
    V.reset_counters()
    delta = V.captured_launches(capture)
    assert (f.launches, g.launches, len(f.by_variant)) == (0, 0, 0)
    for _ in range(3):
        V.count_replay(delta)
    assert (f.launches, g.launches) == (15, 15)
    assert dict(f.by_variant) == {"D3F5+viscous": 15}
    assert dict(g.by_variant) == {"D3F5": 15}
    V.reset_counters()
    assert (f.launches, g.launches, len(g.by_variant)) == (0, 0, 0)
