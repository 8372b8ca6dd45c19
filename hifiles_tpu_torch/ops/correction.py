"""FR correction functions: VCJH family, OFR, OESFR (1-D building blocks).

These define the "lift" operator opp_3 for tensor-product elements.  The VCJH
correction function with parameter eta has derivative (ref:src/funcs.cpp:475-509):

  left : g'_L(r) = 0.5 (-1)^p [P'_p - (eta P'_{p-1} + P'_{p+1}) / (1 + eta)]
  right: g'_R(r) = 0.5        [P'_p + (eta P'_{p-1} + P'_{p+1}) / (1 + eta)]

eta encodes the scheme (ref:src/funcs.cpp:1631-1674):
  DG: 0;  SD: p/(p+1);  Hu: (p+1)/p;  c+: tabulated c values.

Copied from hifiles_tpu/ops/correction.py (lines 1-128) unchanged but for this
paragraph: the port imports nothing of hifiles_tpu, and the
relative imports now resolve inside hifiles_tpu_torch.
"""

from __future__ import annotations

import math

import numpy as np

from .basis import dlagrange_matrix, dlegendre

# vcjh_scheme codes (ref:src/input.cpp:272 & deck comments): 0 = explicit
# eta/c from the deck, 1 = DG, 2 = SD, 3 = Hu, 4 = c_plus, 5 = OFR, 6 = OESFR.
VCJH_CUSTOM = 0
VCJH_DG = 1
VCJH_SD = 2
VCJH_HU = 3
VCJH_CPLUS = 4
OFR = 5
OESFR = 6


def compute_eta(vcjh_scheme: int, order: int) -> float:
    """eta for a named VCJH scheme (ref:src/funcs.cpp:1631-1674)."""
    if order == 0 and vcjh_scheme != VCJH_DG:
        raise ValueError("P=0 only compatible with DG (vcjh_scheme=1)")
    if vcjh_scheme == VCJH_DG:
        return 0.0
    if vcjh_scheme == VCJH_SD:
        return order / (order + 1.0)
    if vcjh_scheme == VCJH_HU:
        return (order + 1.0) / order
    if vcjh_scheme == VCJH_CPLUS:
        c_1d = {2: 0.206, 3: 3.80e-3, 4: 4.67e-5, 5: 4.28e-7}
        if order not in c_1d:
            raise ValueError(f"c_plus scheme not implemented for order {order}")
        return eta_from_c(c_1d[order], order)
    raise ValueError(f"invalid VCJH scheme {vcjh_scheme}")


def eta_from_c(c: float, order: int) -> float:
    """eta(c) (ref:src/funcs.cpp:1664-1665 and :618-619)."""
    ap = (1.0 / 2.0**order) * math.factorial(2 * order) / math.factorial(order) ** 2
    return c * (2 * order + 1) / 2.0 * (math.factorial(order) * ap) ** 2


def dvcjh_1d(r: np.ndarray, mode: int, order: int, eta: float) -> np.ndarray:
    """Derivative of the 1-D VCJH correction function at points ``r``.

    ``mode`` 0 = left-face correction, 1 = right-face
    (ref:src/funcs.cpp:475-509).
    """
    r = np.asarray(r, dtype=np.float64)
    if order == 0:
        blend = dlegendre(r, order + 1) / (1.0 + eta)
    else:
        blend = (eta * dlegendre(r, order - 1) + dlegendre(r, order + 1)) / (1.0 + eta)
    if mode == 0:
        return 0.5 * (-1.0) ** order * (dlegendre(r, order) - blend)
    if mode == 1:
        return 0.5 * (dlegendre(r, order) + blend)
    raise ValueError(f"invalid correction mode {mode}")


_OFR_ZEROS = {
    # interior zeros of the left OFR correction function, orders 1..6
    # (ref:src/funcs.cpp:511-595). Right zeros are the negation, reversed.
    1: [-0.324936024976658],
    2: [-0.683006983995485, 0.302192635873585],
    3: [-0.839877075575685, -0.202221671675099, 0.518569179742482],
    4: [-0.856985048185331, -0.447652424946130, 0.180019033571473,
        0.638102911955799],
    5: [-0.897887439354270, -0.577293821014237, -0.101190259640464,
        0.354120543898467, 0.760380824360528],
    6: [-0.932638621602718, -0.627949285295015, -0.196972255400472,
        0.392803242695776, 0.481615260763104, 0.629467212278235],
}

_OESFR_C = {1: 8.40e-3, 2: 5.83e-4, 3: 3.17e-5, 4: 9.68e-7, 5: 1.02e-8,
            6: 9.76e-11}


def dofr_1d(r: np.ndarray, mode: int, order: int) -> np.ndarray:
    """Derivative of the OFR correction function (ref:src/funcs.cpp:511-595)."""
    if order not in _OFR_ZEROS:
        raise ValueError("OFR schemes available for P = 1 to 6 only")
    zl = np.concatenate([[-1.0], _OFR_ZEROS[order], [1.0]])
    if mode == 0:
        return dlagrange_matrix(r, zl)[:, 0]
    if mode == 1:
        zr = np.concatenate([[-1.0], sorted(-np.array(_OFR_ZEROS[order])), [1.0]])
        return dlagrange_matrix(r, zr)[:, order + 1]
    raise ValueError(f"invalid correction mode {mode}")


def doesfr_1d(r: np.ndarray, mode: int, order: int) -> np.ndarray:
    """Derivative of the OESFR correction function (ref:src/funcs.cpp:597-628)."""
    if order not in _OESFR_C:
        raise ValueError("OESFR schemes available for P = 1 to 6 only")
    eta = eta_from_c(_OESFR_C[order], order)
    return dvcjh_1d(r, mode, order, eta)


def dcorrection_1d(r: np.ndarray, mode: int, order: int, scheme: int,
                   eta_custom: float = 0.0, c_custom: float = 0.0) -> np.ndarray:
    """Dispatch over the correction-function family for tensor elements.

    For scheme 0 the deck supplies eta directly (quads/hexes use ``eta_*``;
    ref:src/eles_quads.cpp:1219-1224).
    """
    if scheme == VCJH_CUSTOM:
        return dvcjh_1d(r, mode, order, eta_custom)
    if scheme in (VCJH_DG, VCJH_SD, VCJH_HU, VCJH_CPLUS):
        return dvcjh_1d(r, mode, order, compute_eta(scheme, order))
    if scheme == OFR:
        return dofr_1d(r, mode, order)
    if scheme == OESFR:
        return doesfr_1d(r, mode, order)
    raise ValueError(f"unknown correction scheme {scheme}")
