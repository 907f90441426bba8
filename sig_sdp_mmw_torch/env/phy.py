"""Physical-layer model: log-distance path loss, Polyanskiy
finite-blocklength BLER and the min-SINR bisection.

Port of :mod:`sig_sdp_mmw_tpu.env.phy`: ``fre_dis_to_loss_db`` and
``polyanskiy_model`` are element-wise torch (``torch.special.erfc``); the
bisection is a host float computation that depends only on static
link-budget parameters and is cached.
"""

from __future__ import annotations

import functools
import math

import torch

NOISE_FLOOR_DBM = -94.0

_SQRT2 = math.sqrt(2.0)


def db_to_dec(db):
    return 10.0 ** (db / 10.0)


def dec_to_db(dec):
    return 10.0 * math.log10(dec)


def noise_dbm(bandwidth_hz) -> float:
    """The reference uses a fixed noise floor."""
    return NOISE_FLOOR_DBM


def fre_dis_to_loss_db(fre_hz, dis: torch.Tensor) -> torch.Tensor:
    """Log-distance path loss (dB) at distances ``dis`` (metres)."""
    L = 20.0 * math.log10(fre_hz / 1e6) + 16.0 - 28.0
    return L + 28.0 * torch.log10(dis + 1.0)


def polyanskiy_model(snr_dec, L_bits, B_hz, T_s) -> torch.Tensor:
    """BLER for (snr, packet bits, bandwidth, slot time), element-wise."""
    snr_dec = torch.as_tensor(snr_dec)
    nu = -L_bits * math.log(2.0) + B_hz * T_s * torch.log1p(snr_dec)
    do = torch.sqrt(B_hz * T_s * (1.0 - 1.0 / (1.0 + snr_dec) ** 2))
    return 0.5 * torch.special.erfc((nu / do) / _SQRT2)


def _polyanskiy_host(snr_dec: float, L_bits: float, B_hz: float,
                     T_s: float) -> float:
    nu = -L_bits * math.log(2.0) + B_hz * T_s * math.log(1.0 + snr_dec)
    do = math.sqrt(B_hz * T_s * (1.0 - 1.0 / ((1.0 + snr_dec) ** 2)))
    return 0.5 * math.erfc((nu / do) / _SQRT2)


def _err(x_db: float, L: float, B: float, T: float, max_err: float) -> float:
    return _polyanskiy_host(db_to_dec(x_db), L, B, T) / max_err - 1.0


@functools.lru_cache(maxsize=None)
def bisection_min_sinr_db(L_bits: float, B_hz: float, T_s: float,
                          max_err: float = 1e-5, a: float = -5.0,
                          b: float = 30.0, tol: float = 0.1) -> float:
    """Minimum SINR (dB) whose BLER equals ``max_err``."""
    if _err(a, L_bits, B_hz, T_s, max_err) * _err(b, L_bits, B_hz, T_s,
                                                  max_err) >= 0:
        raise ValueError("bisection bracket does not straddle the target BLER")
    while (_err(a, L_bits, B_hz, T_s, max_err)
           - _err(b, L_bits, B_hz, T_s, max_err)) > tol:
        mid = (a + b) / 2.0
        e_mid = _err(mid, L_bits, B_hz, T_s, max_err)
        if e_mid == 0:
            return mid
        if _err(a, L_bits, B_hz, T_s, max_err) * e_mid < 0:
            b = mid
        else:
            a = mid
    return (a + b) / 2.0


@functools.lru_cache(maxsize=None)
def min_sinr_dec(L_bits: float, B_hz: float, T_s: float,
                 max_err: float = 1e-5) -> float:
    return db_to_dec(bisection_min_sinr_db(L_bits, B_hz, T_s, max_err))
