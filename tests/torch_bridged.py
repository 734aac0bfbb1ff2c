"""The smoke models both packages run in the port's parity tests, on the
same weights: the JAX model (MoE on backend="pallas", in interpret mode on
the CPU) and the port's, with the JAX weights carried across. Built once
per process and architecture."""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs.registry import get_config


@functools.lru_cache(maxsize=None)
def smoke_pair(arch):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jcfg = jax_config(arch, smoke=True)
    jcfg = jcfg.with_overrides(
        moe=dataclasses.replace(jcfg.moe, backend="pallas"))
    p = JM.model_init(jax.random.PRNGKey(0), jcfg)
    # the JAX model caches its expert groups per MoE config on first use;
    # made here, outside any jit, so no traced copy lands in that cache
    # (a later trace of another function would meet it as a leaked tracer)
    JM.expert_groups(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, get_config(arch, smoke=True), p, tp
