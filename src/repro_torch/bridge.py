"""Carry a parameter tree of numpy arrays across into the port.

The input is the JAX package's parameter pytree (repro/models/model.py
`model_init`) converted leaf by leaf with numpy (`np.asarray`), a step the
caller does. The nesting and the stacked layer axis stay as they are, so
both packages run on identical weights. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bf16: reinterpret
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.int16).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of arrays -> the same nesting of torch tensors on
    `device`. With `dtype`, floating leaves are cast to it; integer leaves
    keep theirs."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)
