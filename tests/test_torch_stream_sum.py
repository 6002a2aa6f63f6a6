"""K3, the segment reduce's streaming floor: the port's plain version against
the TPU kernel of ``scripts/profile_step.py`` (``_stream_kernel``), rebuilt
here in Pallas interpret mode on the CPU, and the CUDA wrapper's refusal of
host tensors (the kernel itself runs only on the card, in chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnn_ecommerce_tpu_torch.ops._kernels import STREAM_SUM, stream_sum, stream_sum_plain

torch.set_num_threads(1)

CH, D, N_CHUNKS = 16, 80, 6  # the probe's [CH, 80] blocks, at a small CH


def _probe_kernel(msgs_ref, out_ref):
    """``scripts/profile_step.py:169-172`` as written."""
    out_ref[:] += jnp.sum(msgs_ref[:, :].astype(jnp.float32), axis=0, keepdims=True)


def _probe_kernel_zero_init(msgs_ref, out_ref):
    """The same with the output zeroed at the first grid step: the sum the
    probe was meant to take."""

    @pl.when(pl.program_id(0) == 0)
    def _():
        out_ref[:] = jnp.zeros_like(out_ref)

    _probe_kernel(msgs_ref, out_ref)


def _run_probe(kernel, msgs):
    return np.asarray(
        pl.pallas_call(
            kernel,
            grid=(msgs.shape[0] // CH,),
            in_specs=[pl.BlockSpec((CH, D), lambda c: (c, 0))],
            out_specs=pl.BlockSpec((1, D), lambda c: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, D), jnp.float32),
            interpret=True,
        )(jnp.asarray(msgs, jnp.bfloat16))
    )


def _msgs(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((CH * N_CHUNKS, D)).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16 values


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_zero_initialized_probe(seed):
    msgs = _msgs(seed)
    ref = _run_probe(_probe_kernel_zero_init, msgs)
    out = stream_sum(torch.from_numpy(msgs).to(torch.bfloat16))
    assert out.shape == (1, D) and out.dtype == torch.float32
    # f32 sums of the same bf16 values in another order: a few f32 ulps of
    # the sum of magnitudes.
    scale = np.abs(msgs).sum(0).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(out, stream_sum_plain(torch.from_numpy(msgs).to(torch.bfloat16)))


def test_probe_as_written_returns_nan_deliberate_difference():
    """The probe never zeroes its accumulator; in interpret mode the output
    starts as NaN, so its result is undefined. The port computes the
    zero-initialized sum instead (ROADMAP §3)."""
    msgs = _msgs(2)
    assert np.isnan(_run_probe(_probe_kernel, msgs)).all()
    assert np.isfinite(stream_sum(torch.from_numpy(msgs).to(torch.bfloat16)).numpy()).all()


def test_kernel_wrapper_refuses_host_tensors():
    msgs = torch.zeros(8, D, dtype=torch.bfloat16)
    before = dict(STREAM_SUM.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        STREAM_SUM(msgs)
    assert STREAM_SUM.launches == before
