"""Run parameters: the TPU-native analog of the reference's ``input`` class.

``RunInput.from_deck`` reproduces read_input_file (ref:src/input.cpp:62-327),
``setup_params`` the non-dimensionalization (ref:src/input.cpp:527-720), and
``read_boundary_params`` the per-boundary-group parameter reads
(ref:src/input.cpp:329-525).  All parameters keep the reference's names so
existing decks run unmodified.

Copied from hifiles_tpu/config/params.py (lines 1-637) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import field

from .deck import Deck

# BCFLAG enum (ref:include/global.h:57-71, ref:src/bc.cpp:36-48)
SUB_IN_SIMP = 0
SUB_OUT_SIMP = 1
SUB_IN_CHAR = 2
SUB_OUT_CHAR = 3
SUP_IN = 4
SUP_OUT = 5
SLIP_WALL = 6
CYCLIC = 7
ISOTHERM_WALL = 8
ADIABAT_WALL = 9
CHAR = 10
SLIP_WALL_DUAL = 11
AD_WALL = 12

BC_TYPE2FLAG = {
    "sub_in_simp": SUB_IN_SIMP, "sub_out_simp": SUB_OUT_SIMP,
    "sub_in_char": SUB_IN_CHAR, "sub_out_char": SUB_OUT_CHAR,
    "sup_in": SUP_IN, "sup_out": SUP_OUT, "slip_wall": SLIP_WALL,
    "cyclic": CYCLIC, "isotherm_wall": ISOTHERM_WALL,
    "adiabat_wall": ADIABAT_WALL, "char": CHAR,
    "slip_wall_dual": SLIP_WALL_DUAL, "ad_wall": AD_WALL,
}
BC_FLAG2TYPE = {v: k for k, v in BC_TYPE2FLAG.items()}


@dataclasses.dataclass
class BCParams:
    """One named boundary group (ref:include/bc.h:30-71)."""
    name: str
    flag: int = -1
    # state parameters (dimensional on read; non-dimensionalized in place)
    rho: float = 0.0
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    p_static: float = 0.0
    T_static: float = 0.0
    p_total: float = 0.0
    T_total: float = 0.0
    mach: float = 0.0
    nx: float = 1.0
    ny: float = 0.0
    nz: float = 0.0
    # ramping
    pressure_ramp: int = 0
    p_ramp_coeff: float = 0.0
    T_ramp_coeff: float = 0.0
    p_total_old: float = 0.0
    T_total_old: float = 0.0
    # wall model / turbulent inlet
    use_wm: int = 0
    inlet_type: int = 0
    mode: int = 0
    vis_y: float = 0.0
    turb_1: float = 0.0
    turb_2: float = 0.0
    n_eddy: int = 0


@dataclasses.dataclass
class RunInput:
    """All run parameters (subset growing toward the full ~150)."""

    # --- basic simulation (ref:src/input.cpp:73-94)
    equation: int = 0
    order: int = 3
    viscous: int = 0
    mesh_file: str = ""
    ic_form: int = 1
    test_case: int = 0
    n_steps: int = 0
    restart_flag: int = 0
    restart_iter: int = 0
    n_restart_files: int = 1

    # --- output / monitoring (ref:src/input.cpp:96-134)
    plot_freq: int = 2**31 - 1
    data_file_name: str = "Mesh"
    restart_dump_freq: int = 2**31 - 1
    monitor_res_freq: int = 100
    monitor_cp_freq: int = 2**31 - 1
    calc_force: int = 0
    area_ref: float = 1.0
    res_norm_type: int = 2
    error_norm_type: int = 2
    p_res: int = 2
    write_type: int = 0
    probe: int = 0
    probe_fields: list[str] = field(default_factory=list)
    probe_freq: int = 0
    probe_source_file: str = ""
    probe_ascii: int = 0
    restart_ascii: int = 0   # restart_flag file format (ref reads both)
    integral_quantities: list[str] = field(default_factory=list)
    diagnostic_fields: list[str] = field(default_factory=list)
    average_fields: list[str] = field(default_factory=list)
    spinup_time: float = 0.0   # time-average start (ref:include/input.h:137)

    # --- solver (ref:src/input.cpp:136-162)
    riemann_solve_type: int = 0
    vis_riemann_solve_type: int = 0
    adv_type: int = 3
    dt_type: int = 0
    dt: float = 0.0
    CFL: float = 0.0
    ldg_tau: float = 0.0
    ldg_beta: float = 0.5

    # --- turbulence (ref:src/input.cpp:164-176)
    RANS: int = 0
    LES: int = 0
    C_s: float = 0.0
    SGS_model: int = 0
    filter_type: int = 0
    filter_ratio: float = 2.0
    wall_model: int = 0
    wall_layer_t: float = 0.0

    # --- gas (ref:src/input.cpp:178-193)
    gamma: float = 1.4
    prandtl: float = 0.72
    prandtl_t: float = 0.9
    S_gas: float = 120.0
    T_gas: float = 291.15
    R_gas: float = 286.9
    mu_gas: float = 1.827e-5
    fix_vis: int = 1
    Mach_free_stream: float = 1.0
    L_free_stream: float = 1.0
    T_free_stream: float = 300.0
    rho_free_stream: float = 1.17723946

    # --- cyclic offsets (ref:src/input.cpp:196-200)
    dx_cyclic: float = math.inf
    dy_cyclic: float = math.inf
    dz_cyclic: float = math.inf

    # --- ICs (ref:src/input.cpp:202-241)
    Mach_c_ic: float = 0.0
    nx_c_ic: float = 1.0
    ny_c_ic: float = 0.0
    nz_c_ic: float = 0.0
    T_c_ic: float = 0.0
    u_c_ic: float = 0.0
    v_c_ic: float = 0.0
    w_c_ic: float = 0.0
    p_c_ic: float = 0.0
    rho_c_ic: float = 0.0
    uvw_c_ic: float = 0.0
    mu_c_ic: float = 0.0
    patch: int = 0
    patch_type: int = 0
    Mv: float = 0.5
    ra: float = 0.075
    rb: float = 0.175
    xc: float = 0.25
    yc: float = 0.5
    patch_x: float = 0.0
    x_shock_ic: float = 0.0
    perturb_ic: int = 0
    # ic_form=6 polynomial velocity coefficients (ref:src/input.cpp:313-325)
    x_coeffs: list[float] = field(default_factory=list)
    y_coeffs: list[float] = field(default_factory=list)
    z_coeffs: list[float] = field(default_factory=list)
    forcing: int = 0
    # channel/hill body-force geometry; defaults are the reference's
    # hard-coded HIOCFD3 C3.4 periodic-hill values (ref:src/eles.cpp:5390-5397)
    body_force_area: float = 9.162
    body_force_vol: float = 114.34
    body_force_mdot0: float = 9.162
    body_force_type: int = 0   # 0 HIOCFD two-step, 1 SD3D relaxation

    # --- shock capture / de-aliasing (ref:src/input.cpp:247-266)
    over_int: int = 0
    over_int_order: int = 0
    shock_cap: int = 0
    shock_det: int = 0
    s0: float = 0.0
    expf_fac: float = 36.0
    expf_order: int = 4
    expf_cutoff: int = 0
    shock_det_field: int = 0

    # --- element parameters (ref:src/input.cpp:268-297)
    upts_type_tri: int = 0
    fpts_type_tri: int = 0
    vcjh_scheme_tri: int = 0
    c_tri: float = 0.0
    sparse_tri: int = 0
    upts_type_quad: int = 0
    vcjh_scheme_quad: int = 0
    eta_quad: float = 0.0
    sparse_quad: int = 0
    upts_type_hexa: int = 0
    vcjh_scheme_hexa: int = 0
    eta_hexa: float = 0.0
    sparse_hexa: int = 0
    upts_type_tet: int = 0
    fpts_type_tet: int = 0
    vcjh_scheme_tet: int = 0
    c_tet: float = 0.0
    eta_tet: float = 0.0
    sparse_tet: int = 0
    upts_type_pri_tri: int = 0
    upts_type_pri_1d: int = 0
    vcjh_scheme_pri_1d: int = 0
    eta_pri: float = 0.0
    sparse_pri: int = 0

    # --- advection-diffusion (ref:src/input.cpp:299-308)
    wave_speed: tuple[float, float, float] = (0.0, 0.0, 0.0)
    diff_coeff: float = 0.0
    lambda_lf: float = 1.0  # 'lambda' in the deck

    # --- derived reference quantities (ref:src/input.cpp:586-681)
    T_ref: float = math.nan
    L_ref: float = math.nan
    rho_ref: float = math.nan
    uvw_ref: float = math.nan
    p_ref: float = math.nan
    mu_ref: float = math.nan
    time_ref: float = math.nan
    R_ref: float = math.nan
    c_sth: float = math.nan
    mu_inf: float = math.nan
    rt_inf: float = math.nan
    Kappa: float = 0.41
    # SA constants (ref:src/input.cpp:669-681)
    c_v1: float = 7.1
    c_v2: float = 0.7
    c_v3: float = 0.9
    c_b1: float = 0.1355
    c_b2: float = 0.622
    c_w2: float = 0.3
    c_w3: float = 2.0
    omega: float = 2.0 / 3.0
    mu_tilde_c_ic: float = 0.0
    mu_tilde_inf: float = 0.0

    bc_list: list[BCParams] = field(default_factory=list)
    _deck: Deck | None = field(default=None, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def from_deck(cls, deck: Deck | str, setup: bool = True) -> "RunInput":
        if isinstance(deck, str):
            deck = Deck.from_file(deck)
        d = deck
        p = cls(_deck=deck)
        g = d.get_scalar

        p.equation = g("equation", int)
        p.order = g("order", int)
        p.viscous = g("viscous", int)
        p.mesh_file = g("mesh_file", str, "")
        p.ic_form = g("ic_form", int, 1)
        p.test_case = g("test_case", int, 0)
        p.n_steps = g("n_steps", int)
        p.restart_flag = g("restart_flag", int, 0)
        if p.restart_flag:
            p.restart_iter = g("restart_iter", int)
            if p.restart_flag == 1:
                p.n_restart_files = g("n_restart_files", int)

        p.plot_freq = g("plot_freq", int, 2**31 - 1)
        p.data_file_name = g("data_file_name", str, "Mesh")
        p.restart_dump_freq = g("restart_dump_freq", int, 2**31 - 1)
        p.monitor_res_freq = g("monitor_res_freq", int, 100)
        p.calc_force = g("calc_force", int, 0)
        if p.calc_force:
            p.monitor_cp_freq = g("monitor_cp_freq", int)
            p.area_ref = g("area_ref", float)
        p.res_norm_type = g("res_norm_type", int, 2)
        p.error_norm_type = g("error_norm_type", int, 2)
        p.p_res = g("p_res", int, 2)
        p.write_type = g("write_type", int, 0)
        p.probe = g("probe", int, 0)
        if p.probe:
            # probe config lives in the same deck
            # (ref:src/probe_input.cpp:295-310 read_probe_input)
            p.probe_fields = [x.lower()
                              for x in d.get_vector("probe_fields")]
            p.probe_freq = g("probe_freq", int)
            p.probe_source_file = g("probe_source_file", str)
            # ASCII per-point probe files instead of HDF5 (the reference
            # selects this at build time via #ifdef _HDF5,
            # ref:src/output.cpp:1403 write_probe_ascii)
            p.probe_ascii = g("probe_ascii", int, 0)
        p.restart_ascii = g("restart_ascii", int, 0)
        p.integral_quantities = [s.lower() for s in
                                 d.get_vector("integral_quantities")]
        p.diagnostic_fields = [s.lower() for s in
                               d.get_vector("diagnostic_fields")]
        p.average_fields = [s.lower() for s in d.get_vector("average_fields")]
        p.spinup_time = g("spinup_time", float, 0.0)

        p.riemann_solve_type = g("riemann_solve_type", int)
        p.vis_riemann_solve_type = g("vis_riemann_solve_type", int, 0)
        p.adv_type = g("adv_type", int)
        p.dt_type = g("dt_type", int)
        if p.dt_type == 0:
            p.dt = g("dt", float)
        else:
            p.CFL = g("CFL", float)
        if p.vis_riemann_solve_type == 0:
            p.ldg_tau = g("ldg_tau", float, 0.0)
            p.ldg_beta = g("ldg_beta", float, 0.5)

        p.RANS = g("RANS", int, 0)
        p.LES = g("LES", int, 0)
        if p.LES:
            p.C_s = g("C_s", float)
            p.SGS_model = g("SGS_model", int)
            if p.SGS_model in (2, 3, 4):
                p.filter_type = g("filter_type", int)
            p.filter_ratio = g("filter_ratio", float)
        p.wall_model = g("wall_model", int, 0)
        p.wall_layer_t = g("wall_layer_thickness", float, 0.0)

        p.gamma = g("gamma", float, 1.4)
        p.prandtl = g("prandtl", float, 0.72)
        p.prandtl_t = g("prandtl_t", float, 0.9)
        p.S_gas = g("S_gas", float, 120.0)
        p.T_gas = g("T_gas", float, 291.15)
        p.R_gas = g("R_gas", float, 286.9)
        p.mu_gas = g("mu_gas", float, 1.827e-5)
        p.fix_vis = g("fix_vis", int, 1)
        p.Mach_free_stream = g("Mach_free_stream", float, 1.0)
        p.L_free_stream = g("L_free_stream", float, 1.0)
        p.T_free_stream = g("T_free_stream", float, 300.0)
        p.rho_free_stream = g("rho_free_stream", float, 1.17723946)

        p.dx_cyclic = g("dx_cyclic", float, math.inf)
        p.dy_cyclic = g("dy_cyclic", float, math.inf)
        p.dz_cyclic = g("dz_cyclic", float, math.inf)

        if p.equation == 0:
            if p.viscous:
                p.Mach_c_ic = g("Mach_c_ic", float)
                p.nx_c_ic = g("nx_c_ic", float, 1.0)
                p.ny_c_ic = g("ny_c_ic", float, 0.0)
                p.nz_c_ic = g("nz_c_ic", float, 0.0)
                p.T_c_ic = g("T_c_ic", float)
            else:
                p.u_c_ic = g("u_c_ic", float)
                p.v_c_ic = g("v_c_ic", float)
                p.w_c_ic = g("w_c_ic", float)
                p.p_c_ic = g("p_c_ic", float)
        p.rho_c_ic = g("rho_c_ic", float)

        p.patch = g("patch", int, 0)
        if p.patch:
            p.patch_type = g("patch_type", int, 0)
            if p.patch_type == 0:
                p.Mv = g("Mv", float, 0.5)
                p.ra = g("ra", float, 0.075)
                p.rb = g("rb", float, 0.175)
                p.xc = g("xc", float, 0.25)
                p.yc = g("yc", float, 0.5)
            elif p.patch_type == 1:
                p.patch_x = g("patch_x", float)

        if p.ic_form in (9, 10):
            p.x_shock_ic = g("x_shock_ic", float)

        p.over_int = g("over_int", int, 0)
        if p.over_int:
            p.over_int_order = g("over_int_order", int)
        p.shock_cap = g("shock_cap", int, 0)
        if p.shock_cap:
            p.shock_det = g("shock_det", int, 0)
            p.s0 = g("s0", float)
            p.expf_fac = g("expf_fac", float, 36.0)
            p.expf_order = g("expf_order", int, 4)
            p.expf_cutoff = g("expf_cutoff", int, 0)
            p.shock_det_field = g("shock_det_field", int, 0)

        p.upts_type_tri = g("upts_type_tri", int, 0)
        p.fpts_type_tri = g("fpts_type_tri", int, 0)
        p.vcjh_scheme_tri = g("vcjh_scheme_tri", int, 0)
        p.c_tri = g("c_tri", float, 0.0)
        p.sparse_tri = g("sparse_tri", int, 0)
        p.upts_type_quad = g("upts_type_quad", int, 0)
        p.vcjh_scheme_quad = g("vcjh_scheme_quad", int, 0)
        p.eta_quad = g("eta_quad", float, 0.0)
        p.sparse_quad = g("sparse_quad", int, 0)
        p.upts_type_hexa = g("upts_type_hexa", int, 0)
        p.vcjh_scheme_hexa = g("vcjh_scheme_hexa", int, 0)
        p.eta_hexa = g("eta_hexa", float, 0.0)
        p.sparse_hexa = g("sparse_hexa", int, 0)
        p.upts_type_tet = g("upts_type_tet", int, 0)
        p.fpts_type_tet = g("fpts_type_tet", int, 0)
        p.vcjh_scheme_tet = g("vcjh_scheme_tet", int, 0)
        p.c_tet = g("c_tet", float, 0.0)
        p.eta_tet = g("eta_tet", float, 0.0)
        p.sparse_tet = g("sparse_tet", int, 0)
        p.upts_type_pri_tri = g("upts_type_pri_tri", int, 0)
        p.upts_type_pri_1d = g("upts_type_pri_1d", int, 0)
        p.vcjh_scheme_pri_1d = g("vcjh_scheme_pri_1d", int, 0)
        p.eta_pri = g("eta_pri", float, 0.0)
        p.sparse_pri = g("sparse_pri", int, 0)

        if p.equation == 1:
            p.wave_speed = (g("wave_speed_x", float),
                            g("wave_speed_y", float, 0.0),
                            g("wave_speed_z", float, 0.0))
            p.diff_coeff = g("diff_coeff", float, 0.0)
            p.lambda_lf = g("lambda", float)

        p.forcing = g("body_forcing", int, 0)
        if p.forcing:
            p.body_force_area = g("body_force_area", float, 9.162)
            p.body_force_vol = g("body_force_vol", float, 114.34)
            p.body_force_mdot0 = g("body_force_mdot0", float, 9.162)
            p.body_force_type = g("body_force_type", int, 0)
        p.perturb_ic = g("perturb_ic", int, 0)
        if p.ic_form == 6:
            p.x_coeffs = [float(x) for x in d.get_vector("x_coeffs")]
            p.y_coeffs = [float(x) for x in d.get_vector("y_coeffs")]
            p.z_coeffs = [float(x) for x in d.get_vector("z_coeffs")]

        if setup:
            p.setup_params()
        return p

    # ------------------------------------------------------------------
    def setup_params(self) -> None:
        """Validation + non-dimensionalization (ref:src/input.cpp:527-720)."""
        if self.p_res < 2:
            raise ValueError("Plot resolution must be at least 2")
        if self.monitor_res_freq == 0:
            self.monitor_res_freq = 1000
        if self.monitor_cp_freq == 0:
            self.monitor_cp_freq = 2**31 - 1

        if self.equation == 0:
            if self.riemann_solve_type == 1:
                raise ValueError("Lax-Friedrich flux not supported with NS/RANS")
            if self.ic_form in (2, 3, 4, 5):
                raise ValueError("IC not supported with NS/RANS equation")
        elif self.equation == 1:
            if self.riemann_solve_type != 1:
                raise ValueError("Riemann solver not supported with adv-diff")
            if self.ic_form not in (2, 3, 4, 5):
                raise ValueError("IC not supported with adv-diff equation")

        if self.RANS:
            if self.riemann_solve_type in (2, 3):
                raise ValueError("Roe/HLLC flux not supported with RANS")
            if not self.viscous:
                raise ValueError("turbulence model needs viscous flow")
            if self.LES:
                raise ValueError("RANS and LES are mutually exclusive")
            if self.wall_model:
                raise ValueError("Cannot use wall model with RANS")
        if self.LES and not self.viscous:
            raise ValueError("LES not supported with inviscid flow")

        if self.viscous and self.equation == 0:
            # reference quantities (ref:src/input.cpp:594-614)
            self.T_ref = self.T_free_stream
            self.L_ref = self.L_free_stream
            self.rho_ref = self.rho_free_stream
            self.uvw_ref = self.Mach_free_stream * math.sqrt(
                self.gamma * self.R_gas * self.T_ref)
            self.p_ref = self.rho_ref * self.uvw_ref**2
            self.mu_ref = self.rho_ref * self.uvw_ref * self.L_ref
            self.time_ref = self.L_ref / self.uvw_ref
            self.R_ref = (self.R_gas * self.T_ref) / self.uvw_ref**2
            self.c_sth = self.S_gas / self.T_gas
            self.mu_inf = self.mu_gas / self.mu_ref
            self.rt_inf = self.T_gas * self.R_gas / self.uvw_ref**2

            if self.dt_type == 0:
                self.dt /= self.time_ref
            if self.calc_force:
                self.area_ref /= self.L_ref**2
            self.dx_cyclic /= self.L_ref
            self.dy_cyclic /= self.L_ref
            self.dz_cyclic /= self.L_ref
            if self.patch:
                if self.patch_type == 0:
                    self.ra /= self.L_ref
                    self.rb /= self.L_ref
                    self.xc /= self.L_ref
                    self.yc /= self.L_ref
                elif self.patch_type == 1:
                    self.patch_x /= self.L_ref
            if self.ic_form in (9, 10):
                self.x_shock_ic /= self.L_ref

            # dimensionless ICs (ref:src/input.cpp:644-663)
            self.uvw_c_ic = self.Mach_c_ic * math.sqrt(
                self.gamma * self.R_gas * self.T_c_ic)
            self.u_c_ic = self.uvw_c_ic * self.nx_c_ic / self.uvw_ref
            self.v_c_ic = self.uvw_c_ic * self.ny_c_ic / self.uvw_ref
            self.w_c_ic = self.uvw_c_ic * self.nz_c_ic / self.uvw_ref
            if self.fix_vis:
                mu_c = self.mu_gas
            else:
                mu_c = (self.mu_gas * (self.T_c_ic / self.T_gas) ** 1.5
                        * (self.T_gas + self.S_gas) / (self.T_c_ic + self.S_gas))
            self.p_c_ic = self.rho_c_ic * self.R_gas * self.T_c_ic / self.p_ref
            self.mu_c_ic = mu_c / self.mu_ref
            self.rho_c_ic = self.rho_c_ic / self.rho_ref
            self.T_c_ic = self.T_c_ic / self.T_ref

            if self.RANS == 1:
                self.mu_tilde_c_ic = 5.0 * self.mu_c_ic
                self.mu_tilde_inf = 5.0 * self.mu_inf

    # ------------------------------------------------------------------
    def read_boundary_params(self, bc_names: list[str]) -> None:
        """Read per-boundary-group parameters from the deck and
        non-dimensionalize them (ref:src/input.cpp:329-525)."""
        if self._deck is None:
            raise RuntimeError("RunInput was not built from a deck")
        d = self._deck
        self.bc_list = []
        for name in bc_names:
            pre = f"bc_{name}_"
            bc = BCParams(name=name)
            bc_type = d.get_scalar(pre + "type", str).lower()
            if bc_type not in BC_TYPE2FLAG:
                raise ValueError(f"Boundary condition '{bc_type}' not implemented")
            bc.flag = BC_TYPE2FLAG[bc_type]
            g = d.get_scalar
            if bc.flag == SUB_IN_SIMP:
                bc.rho = g(pre + "rho", float)
                bc.velocity = (g(pre + "u", float), g(pre + "v", float),
                               g(pre + "w", float))
                bc.inlet_type = g(pre + "inlet_type", int, 0)
                bc.mode = g(pre + "mode", int, 0)
                bc.vis_y = g(pre + "vis_y", float, 0.0)
                bc.turb_1 = g(pre + "turb_1", float, 0.0)
                bc.turb_2 = g(pre + "turb_2", float, 0.0)
                bc.n_eddy = g(pre + "n_eddy", int, 0)
            elif bc.flag == SUB_IN_CHAR:
                bc.p_total = g(pre + "p_total", float)
                bc.T_total = g(pre + "T_total", float)
                bc.pressure_ramp = g(pre + "pressure_ramp", int, 0)
                bc.nx = g(pre + "nx", float, 1.0)
                bc.ny = g(pre + "ny", float, 0.0)
                bc.nz = g(pre + "nz", float, 0.0)
                bc.inlet_type = g(pre + "inlet_type", int, 0)
                if bc.pressure_ramp:
                    bc.p_ramp_coeff = g(pre + "p_ramp_coeff", float, 0.0)
                    bc.T_ramp_coeff = g(pre + "T_ramp_coeff", float, 0.0)
                    bc.p_total_old = g(pre + "p_total_old", float)
                    bc.T_total_old = g(pre + "T_total_old", float,
                                       self.T_free_stream)
            elif bc.flag in (SUB_OUT_SIMP, SUB_OUT_CHAR):
                bc.p_static = g(pre + "p_static", float)
                bc.T_total = g(pre + "T_total", float, self.T_free_stream)
            elif bc.flag in (SUP_IN, CHAR):
                bc.p_static = g(pre + "p_static", float)
                bc.mach = g(pre + "mach", float)
                bc.nx = g(pre + "nx", float, 1.0)
                bc.ny = g(pre + "ny", float, 0.0)
                bc.nz = g(pre + "nz", float, 0.0)
                bc.T_static = g(pre + "T_static", float)
            elif bc.flag == ISOTHERM_WALL:
                if not self.viscous:
                    raise ValueError("Isothermal wall needs viscous simulation")
                bc.T_static = g(pre + "T_static", float)
                bc.velocity = (g(pre + "u", float, 0.0), g(pre + "v", float, 0.0),
                               g(pre + "w", float, 0.0))
                if self.wall_model:
                    bc.use_wm = g(pre + "use_wm", int, 0)
            elif bc.flag == ADIABAT_WALL:
                if not self.viscous:
                    raise ValueError("Adiabatic wall needs viscous simulation")
                bc.velocity = (g(pre + "u", float, 0.0), g(pre + "v", float, 0.0),
                               g(pre + "w", float, 0.0))
                if self.wall_model:
                    bc.use_wm = g(pre + "use_wm", int, 0)
            self.bc_list.append(bc)

        # non-dimensionalize (ref:src/input.cpp:440-524)
        for bc in self.bc_list:
            visc = self.viscous
            if bc.flag == SUB_IN_SIMP and visc:
                bc.rho /= self.rho_ref
                bc.velocity = tuple(v / self.uvw_ref for v in bc.velocity)
            elif bc.flag == SUB_IN_CHAR and visc:
                bc.T_total /= self.T_ref
                bc.p_total /= self.p_ref
                if bc.pressure_ramp:
                    bc.p_total_old /= self.p_ref
                    bc.T_total_old /= self.T_ref
            elif bc.flag in (SUB_OUT_SIMP, SUB_OUT_CHAR) and visc:
                bc.p_static /= self.p_ref
                bc.T_total /= self.T_ref
            elif bc.flag in (SUP_IN, CHAR):
                bc.rho = bc.p_static / (self.R_gas * bc.T_static)
                a = math.sqrt(self.gamma * self.R_gas * bc.T_static)
                bc.velocity = (bc.mach * a * bc.nx, bc.mach * a * bc.ny,
                               bc.mach * a * bc.nz)
                if visc:
                    bc.rho /= self.rho_ref
                    bc.p_static /= self.p_ref
                    bc.T_static /= self.T_ref
                    bc.velocity = tuple(v / self.uvw_ref for v in bc.velocity)
            elif bc.flag == ISOTHERM_WALL and visc:
                bc.T_static /= self.T_ref
                bc.velocity = tuple(v / self.uvw_ref for v in bc.velocity)
            elif bc.flag == ADIABAT_WALL and visc:
                bc.velocity = tuple(v / self.uvw_ref for v in bc.velocity)

    @property
    def n_fields(self) -> int:
        if self.equation == 1:
            return 1
        base = 4 if True else 0  # set per-dims by caller; see n_fields_for
        return base

    def n_fields_for(self, n_dims: int) -> int:
        """Fields of the conservative state (ref:src/eles_quads.cpp:56-64)."""
        if self.equation == 1:
            return 1
        return n_dims + 2 + (1 if self.RANS else 0)
