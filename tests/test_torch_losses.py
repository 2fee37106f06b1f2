"""The port's losses: the reference's test_losses.py case for case on the
port (sharded-safe cross-entropy against a naive oracle, masking, label
smoothing, vocab padding), and `softmax_xent` / `lm_loss` against the
reference on the same inputs (1e-6: float32 sums in another order)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _hyp import given, settings, st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.train.losses import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.losses import softmax_xent as jax_softmax_xent  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.losses import lm_loss, softmax_xent  # noqa: E402
from _torch_parity import bridged_model, to_np  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401


def _naive_xent(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def _randn(seed, shape, scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) \
        * scale


def _randint(seed, shape, high):
    return torch.randint(0, high, shape,
                         generator=torch.Generator().manual_seed(seed))


# ---- the reference's cases

@given(st.integers(0, 2**31 - 1), st.integers(2, 17))
@settings(max_examples=25, deadline=None)
def test_xent_matches_naive(seed, V):
    logits = _randn(seed, (3, 5, V), 3.0)
    labels = _randint(seed + 1, (3, 5), V)
    ours = softmax_xent(logits, labels)
    ref = _naive_xent(logits, labels)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-5)


def test_xent_mask():
    logits = _randn(0, (2, 4, 7))
    labels = torch.zeros((2, 4), dtype=torch.int32)
    mask = torch.tensor([[1, 1, 0, 0], [1, 0, 0, 0]], dtype=torch.float32)
    # only masked-in positions contribute
    m = softmax_xent(logits, labels, mask=mask)
    ref = (_naive_xent(logits[0:1, 0:2], labels[0:1, 0:2]) * 2
           + _naive_xent(logits[1:2, 0:1], labels[1:2, 0:1])) / 3
    np.testing.assert_allclose(float(m), float(ref), rtol=1e-5)


def test_xent_padded_vocab_identical():
    """-1e30-padded logits (vocab padding) leave the loss unchanged."""
    V, pad = 10, 6
    logits = _randn(1, (2, 3, V))
    padded = torch.cat([logits, torch.full((2, 3, pad), -1e30)], dim=-1)
    labels = _randint(2, (2, 3), V)
    np.testing.assert_allclose(float(softmax_xent(logits, labels)),
                               float(softmax_xent(padded, labels)),
                               rtol=1e-5)


def test_label_smoothing_increases_loss_on_confident_model():
    logits = torch.tensor([[[10.0, -10.0, -10.0]]])
    labels = torch.tensor([[0]], dtype=torch.int32)
    plain = float(softmax_xent(logits, labels))
    smooth = float(softmax_xent(logits, labels, label_smoothing=0.1))
    assert smooth > plain


def test_padded_vocab_model_equivalence():
    """A model with vocab padding produces identical losses/logits on real
    ids."""
    base = ModelConfig("t", "dense", 2, 32, 2, 2, 64, 17)
    padded = base.replace(vocab_pad_to=8)     # 17 -> 24
    p_pad = T.init_lm(torch.Generator().manual_seed(0), padded)
    # build an unpadded params view by slicing the table
    p_base = dict(p_pad)
    p_base["embed"] = {"table": p_pad["embed"]["table"][:17]}
    toks = _randint(1, (2, 8), 17)
    lg_pad, _ = T.forward_train(p_pad, padded, {"tokens": toks})
    lg_base, _ = T.forward_train(p_base, base, {"tokens": toks})
    np.testing.assert_allclose(lg_pad[..., :17].numpy(), lg_base.numpy(),
                               atol=1e-5)
    assert float(lg_pad[..., 17:].max()) <= -1e29   # masked


# ---- against the reference

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_xent_matches_reference(masked, smoothing):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 6, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 6)).astype(np.int32)
    mask = (rng.random((3, 6)) < 0.6).astype(np.float32) if masked else None
    ours = softmax_xent(torch.tensor(logits), torch.tensor(labels),
                        None if mask is None else torch.tensor(mask),
                        label_smoothing=smoothing)
    ref = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask),
                           label_smoothing=smoothing)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_all_masked_out_gives_zero_as_in_the_reference():
    logits, labels = _randn(4, (2, 3, 5)), _randint(5, (2, 3), 5)
    ours = softmax_xent(logits, labels, torch.zeros(2, 3))
    ref = jax_softmax_xent(jnp.asarray(logits.numpy()),
                           jnp.asarray(labels.numpy()), jnp.zeros((2, 3)))
    assert float(ours) == float(ref) == 0.0


def test_lm_loss_matches_reference():
    jcfg, tcfg, jp, tp = bridged_model("qwen3-1.7b")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 12)),
             "labels": rng.integers(0, tcfg.vocab_size, (2, 12)),
             "mask": (rng.random((2, 12)) < 0.7).astype(np.float32)}
    loss, m = lm_loss(tp, tcfg, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, T.forward_train)
    jloss, jm = jax_lm_loss(jp, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                            JT.forward_train)
    assert set(m) == set(jm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(to_np(m[k]), to_np(jm[k]), rtol=1e-5)
