"""Operand precision of the reference's products.

The reference runs in float32 with TF32 off.  The same reference runs in a
lower precision with every operand of its products (dense layers, the HS
projections and theta, the KNN distances' inner products) rounded first,
and in the storage formats also every activation a layer hands on (dense
and BatchNorm outputs, each HS layer's output):

* ``tf32``: operands to 10 mantissa bits, round to nearest even, as the
  tensor cores take float32 operands with TF32 on; sums and activations
  stay float32.  The control of a float32 configuration.
* ``bf16``: operands and activations to bfloat16, sums float32: the
  precision a bfloat16 configuration states, the yardstick its gaps are
  measured in.
* ``fp8``: operands and activations per tensor to float8 e4m3 (3 mantissa
  bits), scaled so that the largest magnitude lands on 448, the format's
  largest value.  The control of a bfloat16 configuration.

The rounding is written out rather than asked of the card, so the control
reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

MODES = ("fp32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to 10 mantissa bits, ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 values through per-tensor scaled float8 e4m3."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``op(x)``: an operand as the products of this mode see it.  The
    rounding passes gradients straight through, so a training control
    differentiates the rounded forward."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: one of {MODES}")
        self.mode = mode

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            r = round_tf32(x)
        elif self.mode == "bf16":
            r = x.detach().to(torch.bfloat16).float()
        else:
            r = round_fp8(x)
        return x + (r - x).detach()

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mode == "fp32" else self._round(x)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x) if self.mode in ("bf16", "fp8") else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)
