"""The port's training launcher, `python -m repro_torch.launch.train`, on
the CPU (`--device cpu`): the reference's flags and output lines, the loss
logged every step, checkpoints in the reference's layout that both
packages restore, trained params that serve as they are, and the refusal
of `--device cuda` where torch sees no card."""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.trainer import restore_train_state
from _torch_host import one_torch_thread  # noqa: F401

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--batch", "4",
        "--seq", "16", "--lr", "1e-3", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One launcher run with checkpoints: (its stdout, the checkpoint
    directory)."""
    import contextlib
    import io
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(ARGS + ["--ckpt-dir", str(ckpt)])
    assert rc == 0
    return out.getvalue(), ckpt


def test_prints_the_reference_lines(run):
    out, _ = run
    lines = out.splitlines()
    assert re.fullmatch(r"\[train\] qwen3-1\.7b reduced=True "
                        r"params~[\d.]+M backend=cpu", lines[0])
    steps = [ln for ln in lines if re.match(r"  step +\d+  loss ", ln)]
    assert len(steps) == 6
    m = re.fullmatch(r"\[train\] loss ([\d.]+) -> ([\d.]+) over 6 steps",
                     lines[-1])
    assert m and all(np.isfinite(float(x)) for x in m.groups())


def test_checkpoints_restore_and_serve(run):
    _, ckpt = run
    names = sorted(p.name for p in ckpt.iterdir())
    assert names == ["step_00000003.manifest.json",
                     "step_00000003.proc0.npz",
                     "step_00000006.manifest.json",
                     "step_00000006.proc0.npz"]
    cfg = registry.get("qwen3-1.7b", reduced=True)
    template = T.init_lm(torch.Generator().manual_seed(1), cfg)
    init, _ = adamw(1e-3)
    params, opt = restore_train_state(str(ckpt), 6, template,
                                      init(template), cfg)
    assert int(opt.step) == 6
    first = T.init_lm(torch.Generator().manual_seed(0), cfg)
    for name in ("wq", "wk", "wv", "wo"):      # trained away from the init
        assert not torch.equal(params["layers"][0]["attn"][name],
                               first["layers"][0]["attn"][name])
    eng = ServeEngine(params, cfg, batch_slots=2, cache_len=64,
                      device="cpu")
    eng.submit([1, 2, 3, 4], max_new_tokens=4)
    (req,) = eng.run()
    assert len(req.output) == 4


def test_checkpoint_restores_in_the_reference(run):
    jax = pytest.importorskip("jax")
    from repro.checkpoint import restore_checkpoint
    from repro.configs import registry as jreg
    from repro.models import transformer as JT
    from repro.optim import adamw as jax_adamw
    _, ckpt = run
    jcfg = jreg.get("qwen3-1.7b", reduced=True)
    jp = jax.eval_shape(lambda k: JT.init_lm(k, jcfg),
                        jax.random.PRNGKey(0))
    jinit, _ = jax_adamw(1e-3)
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        {"params": jp, "opt_state": jax.eval_shape(jinit,
                                                                   jp)})
    tree = restore_checkpoint(str(ckpt), 6, like)
    assert int(tree["opt_state"].step) == 6
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.isfinite(a).all()
    # the reference's forward runs on the port's trained weights
    logits, _ = JT.forward_train(tree["params"], jcfg,
                                 {"tokens": np.ones((1, 8), np.int32)})
    assert np.isfinite(np.asarray(logits)).all()


def test_cuda_without_a_card_is_refused():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")
    with pytest.raises(SystemExit, match="no CUDA"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced",
                           "--steps", "1"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2", "pixtral-12b"])
def test_other_families_train_on_stub_inputs(arch, capsys):
    """The MoE, encoder-decoder and modality-prefix archs train through
    the launcher, on the reference's stub inputs: seq // 2 zero encoder
    frames (at least 4) or a zero prefix of seq // 4 rows (at least 2)."""
    cfg = registry.get(arch, reduced=True)
    stubs = launch_train.stub_inputs(cfg, 4, 16, torch.device("cpu"))
    want = ({"enc_embeds": (4, 8, cfg.d_model)} if cfg.is_encdec
            else {"embeds": (4, 4, cfg.d_model)} if cfg.embed_stub else {})
    assert {k: tuple(v.shape) for k, v in stubs.items()} == want
    assert all(not v.any() for v in stubs.values())
    rc = launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                            "--batch", "4", "--seq", "16", "--device", "cpu"])
    assert rc == 0
    m = re.search(r"\[train\] loss ([\d.]+) -> ([\d.]+) over 2 steps",
                  capsys.readouterr().out)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
