"""The port's RG-LRU scan plain version (repro_torch/kernels/rglru_scan/
ref.py, what `ops.rglru_scan` runs for CPU tensors) against the
reference's Pallas kernel in interpret mode and its `lax.scan` oracle, on
the reference's three kernel cases (tests/test_kernels.py RGLRU_CASES) in
f32 and bf16 inputs, the model's log-depth scan (`models.rglru.
_linear_scan`, the "xla" route) against the same oracle, and the plain
model of the kernel's chunked scan (`rglru_chunked_ref`) against the
sequential plain version, the oracle and the Pallas kernel.

Tolerances are the reference kernel test's own: 1e-4 for f32 inputs, 5e-2
for bf16 inputs. Inputs are numpy draws from a seed; bf16 inputs are
rounded from the same f32 values on both sides. The kernel itself is
tested on the card (test_torch_rglru_scan_cuda.py).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_ref as jax_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_chunked_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.models.rglru import _linear_scan  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

RGLRU_CASES = [
    # B, S, C, block_s, block_c
    (2, 32, 64, 8, 32),
    (1, 100, 130, 16, 64),     # ragged seq + channels
    (2, 16, 16, 16, 16),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _ab(B, S, C, seed=3):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, C))))
    return a.astype(np.float32), rng.standard_normal((B, S, C)) \
        .astype(np.float32)


@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_reference(case, dtype):
    B, S, C, bs, bc = case
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(B, S, C)
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    ta, tb = torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt)
    jy, jh = jax_rglru_scan(ja, jb, block_s=bs, block_c=bc, interpret=True)
    oracle = np.asarray(jax_ref(ja, jb))
    y, h = rglru_scan(ta, tb)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, C)
    np.testing.assert_array_equal(y.numpy(), rglru_ref(ta, tb).numpy())
    np.testing.assert_array_equal(h.numpy(), y[:, -1].numpy())
    np.testing.assert_allclose(y.numpy(), oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=tol, rtol=tol)
    # the "xla" route's log-depth scan computes the same recurrence
    np.testing.assert_allclose(_linear_scan(ta.float(), tb.float()).numpy(),
                               oracle, atol=tol, rtol=tol)


def test_cpu_tensors_never_count_as_launches():
    a, b = (torch.as_tensor(x) for x in _ab(1, 8, 4))
    before = rglru_scan.launches
    rglru_scan(a, b)
    assert rglru_scan.launches == before
    with pytest.raises(ValueError, match="time step"):
        rglru_scan(a[:, :0], b[:, :0])


# the plain model of the kernel's chunked scan (ref.rglru_chunked_ref) at
# each chunk the kernel is built for, on the reference's cases and on
# ragged sequences of 20, 100 and 1,000 steps (ragged channels too)
CHUNKED_CASES = [case[:3] for case in RGLRU_CASES] + [
    (2, 20, 48), (1, 100, 130), (1, 1000, 200)]


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("case", CHUNKED_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_ref_matches_sequential_and_pallas(case, dtype, chunk):
    B, S, C = case
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(B, S, C)
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    ta, tb = torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt)
    y = rglru_chunked_ref(ta, tb, chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == case
    np.testing.assert_allclose(y.numpy(), rglru_ref(ta, tb).numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_ref(ja, jb)),
                               atol=tol, rtol=tol)
    # the Pallas kernel pads a ragged S or C with the identity
    jy, _ = jax_rglru_scan(ja, jb, block_s=min(16, S), block_c=min(128, C),
                           interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=tol, rtol=tol)
