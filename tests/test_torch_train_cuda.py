"""Training on the card: the four kernel wrappers refuse a backward on
CUDA tensors (none has one, as none of the reference's Pallas kernels
has), a train step on the card equals the same step on the CPU,
trained params serve on the card through the kernels, and a restore into
card params lands on the card.

Skips cleanly where torch sees no CUDA device. Imports no JAX: the machine
with the card has none. Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py``.
"""
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import build_lm_train_step

pytestmark = pytest.mark.gpu
REL = 1e-4          # chip_smoke.py phase 21's card-against-CPU tolerance


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _r(device, *shape, dtype=torch.float32):
    g = torch.Generator(device).manual_seed(sum(shape))
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_wrapper_refuses_a_gradient_on_cuda(device, dtype):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.ssd_scan import ops as ssd

    def r(*shape):
        return _r(device, *shape, dtype=dtype).requires_grad_()
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
    pos = torch.tensor([20], dtype=torch.int32, device=device)
    f32 = torch.float32
    calls = {
        fa.flash_attention: lambda: fa.flash_attention(
            r(1, 64, 4, 64), r(1, 64, 2, 64), r(1, 64, 2, 64)),
        rg.rglru_scan: lambda: rg.rglru_scan(
            torch.rand(1, 64, 128, device=device).to(dtype)
            .requires_grad_(), r(1, 64, 128)),
        ssd.ssd_scan: lambda: ssd.ssd_scan(
            r(1, 64, 2, 32), torch.rand(1, 64, 2, device=device,
                                        dtype=f32).requires_grad_(),
            -torch.rand(2, device=device), r(1, 64, 1, 32), r(1, 64, 1, 32)),
        pa.paged_attention: lambda: pa.paged_attention(
            r(1, 4, 64), r(3, 16, 2, 64), r(3, 16, 2, 64), table, pos),
    }
    for wrapper, call in calls.items():
        before = wrapper.launches
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
        assert wrapper.launches == before        # refused before launching
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        out = out[0] if isinstance(out, tuple) else out
        assert out.is_cuda and torch.isfinite(out.float()).all()
        assert wrapper.launches == before + 1


def _train(params, cfg, batches, device):
    init, update = adamw(1e-3)
    step = build_lm_train_step(cfg, update)
    opt, out = init(params), []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.as_tensor(v, device=device)
                                            for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return params, out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b",
                                  "mamba2-130m"])
def test_train_steps_on_the_card_equal_the_cpu(device, arch):
    cfg = registry.get(arch, reduced=True)
    cpu = T.init_lm(torch.Generator().manual_seed(0), cfg)
    card = tree_map(lambda p: p.to(device), cpu)
    stream = TokenStream(cfg.vocab_size, 64, 4, seed=1)
    batches = [stream.next_batch() for _ in range(3)]
    _, on_card = _train(card, cfg, batches, device)
    _, on_cpu = _train(cpu, cfg, batches, torch.device("cpu"))
    for (l_a, g_a), (l_b, g_b) in zip(on_card, on_cpu):
        assert l_a == pytest.approx(l_b, rel=REL)
        assert g_a == pytest.approx(g_b, rel=REL)


def test_trained_params_serve_on_the_card(device):
    cfg = registry.get("qwen3-1.7b", reduced=True)
    params = T.init_lm(torch.Generator(device).manual_seed(0), cfg)
    stream = TokenStream(cfg.vocab_size, 32, 4, seed=2)
    params, losses = _train(params, cfg, [stream.next_batch()
                                          for _ in range(3)], device)
    assert all(not p.requires_grad for p in torch.utils._pytree.tree_leaves(
        params))
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    for layout, c in (("paged", cfg),
                      ("dense", cfg.replace(attention_impl="pallas"))):
        fa.flash_attention.launches = pa.paged_attention.launches = 0
        eng = ServeEngine(params, c, batch_slots=2, cache_len=128,
                          kv_layout=layout, prefill_mode="bulk",
                          device="cuda")
        eng.submit(list(range(1, 20)), max_new_tokens=6)
        (req,) = eng.run()
        assert len(req.output) == 6
        if layout == "paged":
            assert pa.paged_attention.launches > 0
        else:
            assert fa.flash_attention.launches == cfg.n_layers


def test_a_restore_into_card_params_lands_on_the_card(device, tmp_path):
    """With no device given, the restore follows the template's leaves."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.train.trainer import restore_train_state
    cfg = registry.get("qwen3-1.7b", reduced=True)
    params = T.init_lm(torch.Generator(device).manual_seed(0), cfg)
    opt_init, _ = adamw(1e-3)
    save_checkpoint(str(tmp_path), 1, {"params": params,
                                       "opt_state": opt_init(params)})
    template = T.init_lm(torch.Generator(device).manual_seed(1), cfg)
    p, opt = restore_train_state(str(tmp_path), 1, template,
                                 opt_init(template))
    assert {t.device.type for t in tree_leaves((p, opt.mu, opt.nu))} \
        == {"cuda"}
    for a, b in zip(tree_leaves(p), tree_leaves(params)):
        assert torch.equal(a, b)
