"""The port's SSD scan (repro_torch/kernels/ssd_scan: `ops.ssd_scan`, which
runs the plain version ref.py for CPU tensors) against the reference's
Pallas kernel in interpret mode and its `lax.scan` oracle, on the
reference's four kernel cases (tests/test_kernels.py SSD_CASES) in f32 and
bf16; on ragged sequences (not a multiple of the chunk, which the
reference's Pallas wrapper refuses) against the reference's XLA route
`models.mamba2.ssd_chunked`; the port's own `ssd_chunked` (the "xla"
route) against the same functions; the plain model of the kernel's
tensor-core route (`ssd_chunk_passes_ref`) against the sequential plain
version, the reference's oracle and its Pallas kernel; and the wrapper's
route rule.

Tolerances are the reference kernel test's own: 2e-4 in f32, 5e-2 in bf16.
Inputs are numpy draws from a seed; bf16 inputs are rounded from the same
f32 values on both sides. The kernel itself is tested on the card
(test_torch_ssd_scan_cuda.py).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import route, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_passes_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402
from _torch_parity import to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

SSD_CASES = [
    # b, s, h, p, g, n, chunk
    (2, 32, 4, 16, 1, 8, 8),
    (1, 64, 2, 8, 2, 16, 16),
    (2, 16, 4, 32, 1, 32, 16),
    (1, 128, 3, 16, 1, 8, 32),   # heads not a multiple of anything
]
# sequences that are not a multiple of the chunk (the reduced mamba2-130m
# has chunk 16; the reference's Pallas wrapper asserts on both)
RAGGED_CASES = [
    (2, 20, 4, 16, 1, 32, 16),
    (1, 100, 4, 8, 2, 16, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(b, s, h, p, g, n, seed=1):
    """f32 numpy x, dt, A, B, C with the reference test's distributions:
    dt = softplus(N(0,1)) * 0.1, A = -exp(N(0,1) * 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal((h,)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _both(case, dtype):
    """The same inputs as (jax arrays, torch tensors): x, B and C in
    `dtype`, dt and A in f32 (as the model hands them over)."""
    jdt, tdt, _ = DTYPES[dtype]
    x, dt, A, B, C = _inputs(*case[:6])
    jx = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt))
    tx = (torch.as_tensor(x).to(tdt), torch.as_tensor(dt),
          torch.as_tensor(A), torch.as_tensor(B).to(tdt),
          torch.as_tensor(C).to(tdt))
    return jx, tx


def _close(t, j, tol):
    np.testing.assert_allclose(to_np(t), to_np(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_reference(case, dtype):
    chunk, tol = case[-1], DTYPES[dtype][2]
    jx, tx = _both(case, dtype)
    jy, jst = jax_ssd_scan(*jx, chunk_size=chunk, interpret=True)
    oy, ost = jax_ssd_ref(*jx)
    y, st = ssd_scan(*tx)
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    assert tuple(y.shape) == case[:4]
    assert tuple(st.shape) == (case[0], case[2], case[3], case[5])
    ry, rst = ssd_ref(*tx)
    np.testing.assert_array_equal(to_np(y), to_np(ry.to(y.dtype)))
    np.testing.assert_array_equal(st.numpy(), rst.numpy())
    for ref_y, ref_st in ((jy, jst), (oy, ost)):
        _close(y, ref_y, tol)
        _close(st, ref_st, tol)


@pytest.mark.parametrize("case", SSD_CASES + RAGGED_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_route_matches_reference(case, dtype):
    """The port's `ssd_chunked` (the "xla" route, a loop over chunks with
    dt = 0 padding for a ragged end) against the reference's."""
    chunk, tol = case[-1], DTYPES[dtype][2]
    jx, tx = _both(case, dtype)
    jy, jst = jax.jit(jax_ssd_chunked, static_argnums=5)(*jx, chunk)
    y, st = ssd_chunked(*tx, chunk)
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    _close(y, jy, tol)
    _close(st, jst, tol)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_sequences_are_served(case, dtype):
    """A sequence that is not a multiple of the chunk: the reference's
    Pallas wrapper asserts (ROADMAP.md Queue 3), the port's wrapper
    computes it, and agrees with the reference's XLA route and oracle; the
    final state is the state after the last real token."""
    chunk, tol = case[-1], DTYPES[dtype][2]
    jx, tx = _both(case, dtype)
    with pytest.raises(AssertionError):
        jax_ssd_scan(*jx, chunk_size=chunk, interpret=True)
    y, st = ssd_scan(*tx)
    for ref_y, ref_st in (jax.jit(jax_ssd_chunked, static_argnums=5)(
            *jx, chunk), jax_ssd_ref(*jx)):
        _close(y, ref_y, tol)
        _close(st, ref_st, tol)


def test_cpu_tensors_never_count_as_launches():
    _, tx = _both((1, 8, 2, 4, 1, 4, 8), "float32")
    before = ssd_scan.launches
    ssd_scan(*tx)
    assert ssd_scan.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd_scan(*(t.to("meta") for t in tx))


# the plain model of the tensor-core route's three passes
# (ref.ssd_chunk_passes_ref) at each chunk the kernel is built for, on the
# reference's cases and on ragged sequences of 20, 100 and 1,000 tokens
# (none a multiple of every chunk)
PASSES_CASES = SSD_CASES + RAGGED_CASES + [(1, 1000, 8, 64, 1, 128, 256)]


@functools.cache
def _oracles(case, dtype):
    """The reference's lax.scan oracle and, where the sequence is a
    multiple of the case's chunk, its Pallas kernel in interpret mode."""
    jx, _ = _both(case, dtype)
    out = [tuple(to_np(t) for t in jax_ssd_ref(*jx))]
    if case[1] % case[-1] == 0:
        out.append(tuple(to_np(t) for t in jax_ssd_scan(
            *jx, chunk_size=case[-1], interpret=True)))
    return out


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("case", PASSES_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunk_passes_match_sequential_and_pallas(case, dtype, chunk):
    tol = DTYPES[dtype][2]
    _, tx = _both(case, dtype)
    y, st = ssd_chunk_passes_ref(*tx, chunk)
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    assert tuple(y.shape) == case[:4]
    ry, rst = ssd_ref(*tx)
    _close(y, ry, tol)
    _close(st, rst, tol)
    for oy, ost in _oracles(case, dtype):
        np.testing.assert_allclose(to_np(y), oy, atol=tol, rtol=tol)
        np.testing.assert_allclose(st.numpy(), ost, atol=tol, rtol=tol)


def test_route_rule():
    """bf16 tiles the tensor cores take run "mma" (the model's strided xBC
    views included); f32, head dims or d_state off the tiles, and bases or
    strides off 16 bytes run "simt"."""
    b, s, h, p, g, n = 1, 40, 4, 64, 1, 128
    di = h * p
    xBC = torch.zeros((b, s, di + 2 * g * n), dtype=torch.bfloat16)
    x = xBC[..., :di].reshape(b, s, h, p)
    B = xBC[..., di:di + g * n].reshape(b, s, g, n)
    C = xBC[..., di + g * n:].reshape(b, s, g, n)
    assert route(x, B, C) == "mma"
    assert route(x.float(), B.float(), C.float()) == "simt"
    assert route(x[..., :48], B, C) == "simt"            # p 48
    assert route(x, B[..., :120], C[..., :120]) == "simt"  # n 120
    odd = torch.zeros((b, s, di + 2 * g * n + 4), dtype=torch.bfloat16)
    assert route(odd[..., :di].reshape(b, s, h, p), B, C) == "simt"
    shifted = xBC.reshape(-1)[1:1 + b * s * di].reshape(b, s, h, p)
    assert route(shifted, B, C) == "simt"
