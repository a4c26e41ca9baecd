"""Raw record formats and their codecs (counterpart of ``repro.data.formats``).

* :class:`AsciiFixedFormat` — fixed-width ASCII decimal.  Each field is 16
  bytes: ``sign, 8 integer digits, '.', 6 fraction digits``.
* :class:`BinaryBigEndianFormat` — big-endian float32 records (FITS-like).

``encode`` is host numpy (used by the generators); ``decode_ref`` is the
plain PyTorch decode.  The ASCII decode accumulates the digit terms one at a
time, most significant first, each as a fused multiply-add (product and sum
formed in float64, where both are exact for these operands, then rounded to
float32 once).  That is the order and rounding the reference's f32 einsum
takes on the CPU, so the two decodes agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT_DIGITS = 8
FRAC_DIGITS = 6
FIELD_BYTES = 1 + INT_DIGITS + 1 + FRAC_DIGITS  # sign + digits + '.' + digits
_MAX_ABS = 10.0 ** INT_DIGITS

_IPOW = [float(np.float32(10 ** (INT_DIGITS - 1 - d))) for d in range(INT_DIGITS)]
_FPOW = [float(np.float32(10.0 ** -(d + 1))) for d in range(FRAC_DIGITS)]


def _digit_sum(digits: torch.Tensor, pows: list) -> torch.Tensor:
    """Σ_d digits[..., d] · pows[d] -> f32, one fused multiply-add per digit
    in index order.  A digit times an f32 power is exact in float64, and so
    is its sum with an f32 partial below 2^53, so each step rounds once."""
    d64 = digits.to(torch.float64)
    acc = (d64[..., 0] * pows[0]).to(torch.float32)
    for d in range(1, len(pows)):
        acc = (acc.to(torch.float64) + d64[..., d] * pows[d]).to(torch.float32)
    return acc


@dataclasses.dataclass(frozen=True)
class AsciiFixedFormat:
    """Fixed-width ASCII decimal records (text family)."""

    num_cols: int
    name: str = "ascii"

    @property
    def record_bytes(self) -> int:
        return self.num_cols * FIELD_BYTES

    def encode(self, values: np.ndarray) -> np.ndarray:
        """(T, C) float -> (T, record_bytes) uint8."""
        t, c = values.shape
        assert c == self.num_cols, (c, self.num_cols)
        v = np.asarray(values, np.float64)
        if np.any(np.abs(v) >= _MAX_ABS):
            raise ValueError(f"values must be < 1e{INT_DIGITS} in magnitude")
        sign = np.where(v < 0, ord("-"), ord("+")).astype(np.uint8)
        av = np.abs(v)
        ip = np.floor(av)
        fp = np.rint((av - ip) * 10 ** FRAC_DIGITS).astype(np.int64)
        carry = fp >= 10 ** FRAC_DIGITS          # rounding .999999x up
        ip = ip.astype(np.int64) + carry
        fp = np.where(carry, 0, fp)
        out = np.empty((t, c, FIELD_BYTES), np.uint8)
        out[..., 0] = sign
        for d in range(INT_DIGITS):              # most-significant first
            div = 10 ** (INT_DIGITS - 1 - d)
            out[..., 1 + d] = (ip // div % 10 + ord("0")).astype(np.uint8)
        out[..., 1 + INT_DIGITS] = ord(".")
        for d in range(FRAC_DIGITS):
            div = 10 ** (FRAC_DIGITS - 1 - d)
            out[..., 2 + INT_DIGITS + d] = (fp // div % 10
                                            + ord("0")).astype(np.uint8)
        return out.reshape(t, self.record_bytes)

    def decode_ref(self, raw: torch.Tensor) -> torch.Tensor:
        """(..., record_bytes) uint8 -> (..., C) float32."""
        lead = raw.shape[:-1]
        f = raw.reshape(*lead, self.num_cols, FIELD_BYTES).to(torch.int32)
        zero = ord("0")
        ival = _digit_sum((f[..., 1:1 + INT_DIGITS] - zero).to(torch.float32),
                          _IPOW)
        fval = _digit_sum((f[..., 2 + INT_DIGITS:] - zero).to(torch.float32),
                          _FPOW)
        sign = torch.where(f[..., 0] == ord("-"), -1.0, 1.0).to(torch.float32)
        return sign * (ival + fval)

    def extract_cost_per_tuple(self) -> float:
        """Modeled op count per tuple (the resource monitor's CPU term)."""
        return float(self.num_cols * (INT_DIGITS + FRAC_DIGITS) * 30)


@dataclasses.dataclass(frozen=True)
class BinaryBigEndianFormat:
    """Big-endian float32 records (FITS-like binary family)."""

    num_cols: int
    name: str = "binary"

    @property
    def record_bytes(self) -> int:
        return self.num_cols * 4

    def encode(self, values: np.ndarray) -> np.ndarray:
        v = np.asarray(values, ">f4")  # big-endian on purpose (FITS convention)
        return v.view(np.uint8).reshape(values.shape[0], self.record_bytes)

    def decode_ref(self, raw: torch.Tensor) -> torch.Tensor:
        lead = raw.shape[:-1]
        b = raw.reshape(*lead, self.num_cols, 4).to(torch.int64)
        word = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
        # the low 32 bits as a signed int32 carry the IEEE pattern
        word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
        return word.to(torch.int32).view(torch.float32)

    def extract_cost_per_tuple(self) -> float:
        return float(self.num_cols * 4)  # byte shuffles only: near-free


FORMATS = {"ascii": AsciiFixedFormat, "binary": BinaryBigEndianFormat}
