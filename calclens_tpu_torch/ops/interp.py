"""The six field maps of the SHT Poisson solve (port of
calclens_tpu/ops/interp.py::FieldMaps).  The interpolation of the maps to
rays, with parallel transport, is rays/soa.py::interp_and_prop_chunk."""

from __future__ import annotations

from typing import NamedTuple

import torch


class FieldMaps(NamedTuple):
    """The six RING-ordered maps produced by the SHT Poisson solve."""

    pot: torch.Tensor
    gt: torch.Tensor
    gp: torch.Tensor
    gtt: torch.Tensor
    gtp: torch.Tensor
    gpp: torch.Tensor
