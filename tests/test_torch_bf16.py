"""The port's decoder against the JAX package's in bfloat16, on the CPU.

Every other parity test runs the tiny config in float32, where the two
packages agree to 1e-5; the 8B main paths run bfloat16. Here the tiny
decoder runs in bfloat16 with the same weights in both packages (made by
the JAX package in bf16, carried over bit for bit), fp and int8, and a
96-token forward's logits are held JAX against torch by their relative
norm error, and each package against the same weights in float32.

The ops are the same in the same order, yet the bf16 logits differ by
about 4e-3: XLA fuses a bf16 elementwise chain (RMSNorm, RoPE, SwiGLU) and
rounds once at its end, where PyTorch's eager ops round after each one. So
byte-equal logits are not a bar bf16 can meet, and the bounds below are set
from readings, as the kernels' are: over seeds 0 to 2, JAX against torch
read 4.24e-3 to 4.34e-3 (fp) and 4.62e-3 to 4.67e-3 (int8); each package
against float32 4.34e-3 to 4.43e-3 (fp) and 5.41e-3 to 5.76e-3 (int8),
torch's error within 1.3 % of JAX's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.models import quant as jax_quant

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy

T = 96
# relative norm error of the logits, JAX against torch, both in bf16
REL_JAX_TORCH = {None: 6e-3, 8: 7e-3}
# torch's error against float32 as a share of JAX's
FP32_SHARE = 1.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fp32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if a.dtype.name == "bfloat16" else a, tree)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_logits_match_jax(seed, bits):
    jcfg = jax_tiny_live().llama
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg16 = dataclasses.replace(tiny_live_config().llama, dtype="bfloat16")
    params = jax.device_get(jax_llama.init_params(jax.random.PRNGKey(seed),
                                                  jcfg16))
    if bits:
        params = jax.device_get(jax_quant.quantize_llama_params(params,
                                                                bits=bits))
    ids = np.random.RandomState(seed).randint(0, jcfg.vocab_size,
                                              size=(1, T))
    want, _ = jax_llama.forward(params, cfg=jcfg16, input_ids=jnp.asarray(ids))
    got, _ = llama.forward(params_from_numpy(params, device="cpu"),
                           cfg=cfg16, input_ids=torch.tensor(ids))
    ref, _ = jax_llama.forward(_fp32(params), cfg=jcfg,
                               input_ids=jnp.asarray(ids))
    want, ref = np.asarray(want, np.float32), np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape == (1, T, jcfg.vocab_size)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= REL_JAX_TORCH[bits]
    assert _rel(got, ref) <= FP32_SHARE * _rel(want, ref)
