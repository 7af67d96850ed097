"""kasportsformer_torch's training path against the JAX package, on the CPU
at a small size (`torch_parity.SMALL`, numpy-drawn weights loaded into
both): the train-mode forward and batch-norm running statistics, the loss
components and gradients of `make_grads_fn` (full batch and microbatched),
one AdamW step against optax, the LR schedule, the eval protocol, the clip
store, a 2-epoch `train` / `evaluate` through the CLI, and a kill-and-resume
bitwise equal to an uninterrupted run."""

import io
import json
import logging
import os
import pickle
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kasportsformer_tpu.config import Config as JConfig
from kasportsformer_tpu.data import clips as JC
from kasportsformer_tpu.data import sources
from kasportsformer_tpu.train import loop as JL
from kasportsformer_tpu.train.evaluator import Evaluator as JEvaluator
from kasportsformer_torch import cli
from kasportsformer_torch.config import Config
from kasportsformer_torch.data import clips as TC
from kasportsformer_torch.models import build_model
from kasportsformer_torch.train import checkpoint as ckpt
from kasportsformer_torch.train import loop as TLP
from kasportsformer_torch.train.checkpoint import state_dict_from_jax
from kasportsformer_torch.train.evaluator import Evaluator, format_eval_report
from tests.fixtures import make_source
from torch_parity import SMALL, jax_flagship, torch_flagship

RNG = np.random.default_rng(41)
# small shapes gain nothing from intra-op threads: leave the cores to the
# suite's other workers
torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)  # float32 forwards, summation order only
# loss components rel 1e-5; gradients rtol 1e-4, atol 1e-6
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


# The gradient tests take one trunk layer: compiling the JAX package's
# `make_grads_fn` costs ~10 s a variant there against ~15 s at SMALL's
# three; the scanned layers >= 1 are held by the train-mode forward test.
GRAD = dict(SMALL, n_layers=1)


@pytest.fixture(scope="module")
def small():
    return jax_flagship(12, **SMALL)


@pytest.fixture(scope="module")
def one_layer():
    return jax_flagship(13, **GRAD)


@pytest.fixture(scope="module")
def sliced(tmp_path_factory):
    """A make_source clip set, sliced by the JAX package's source reader
    (the port's `preprocess` waits for a later slice)."""
    path = tmp_path_factory.mktemp("src") / "source.pkl"
    with open(path, "wb") as f:
        pickle.dump(make_source("sportspose", train_video_lens=(36, 45, 63),
                                test_video_lens=(27, 54), seed=2), f)
    reader = sources.PoseSourceReader(str(path), "sportspose", n_frames=27, seed=1)
    return reader.get_sliced_data()


def _batch(b: int = 8):
    x = RNG.uniform(-1, 1, (b, 27, 17, 3)).astype(np.float32)
    y = (0.3 * RNG.standard_normal((b, 27, 17, 3))).astype(np.float32)
    return x, y - y[:, :, :1]


def test_train_mode_forward_and_running_stats_match_jax(small):
    model, params, state = small
    port = torch_flagship(params, state, **SMALL).train()
    x, _ = _batch(4)
    want, new_state = jax.jit(lambda p, s, xx: model.apply(p, s, xx, train=True))(
        params, state, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_sd = state_dict_from_jax(params, jax.tree.map(np.asarray, new_state))
    sd = port.state_dict()
    keys = [k for k in sd if "running" in k]
    assert len(keys) == 2 * 2 * SMALL["n_layers"]
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), **TOL,
                                   err_msg=k)


_GRAD_BATCH = _batch(8)
_GRAD_WEIGHTS = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


@pytest.fixture(scope="module")
def jax_grads(one_layer):
    """`make_grads_fn` of the JAX package on one batch with two padded
    samples, full batch (0) and in microbatches of 4: (gradients as a
    state_dict, loss components, the state_dict of the updated running
    statistics, the raw gradient pytree)."""
    model, params, state = one_layer
    out = {}
    for microbatch in (0, 4):
        cfg = JConfig(batch_size=8, flip=False, grad_microbatch=microbatch)
        grads, comps, new_state = jax.jit(JL.make_grads_fn(model, cfg))(
            params, state, *_GRAD_BATCH, _GRAD_WEIGHTS, jax.random.key(0))
        out[microbatch] = (
            state_dict_from_jax(jax.tree.map(np.asarray, grads), state),
            {k: float(v) for k, v in comps.items()},
            state_dict_from_jax(params, jax.tree.map(np.asarray, new_state)),
            grads)
    return out


def _port_grads(params, state, microbatch, lr=5e-4):
    port = torch_flagship(params, state, **GRAD)
    cfg = Config(batch_size=8, flip=False, grad_microbatch=microbatch,
                 learning_rate=lr)
    comps = TLP.make_grads_fn(port, cfg)(
        *(torch.from_numpy(a) for a in (*_GRAD_BATCH, _GRAD_WEIGHTS)))
    return port, cfg, comps


@pytest.mark.parametrize("microbatch", [0, 4])
def test_grads_match_jax_make_grads_fn(one_layer, jax_grads, microbatch):
    """Loss components and every parameter's gradient, with two padded
    samples in the batch; microbatched, the batch-norm statistics thread
    through the microbatches as in the JAX scan."""
    _, params, state = one_layer
    want_g, want_c, want_sd, _ = jax_grads[microbatch]
    port, _, comps = _port_grads(params, state, microbatch)
    assert set(comps) == set(want_c)
    for k, v in want_c.items():
        assert comps[k].item() == pytest.approx(v, rel=1e-5), k
    unreached = 0
    for name, p in port.named_parameters():
        if p.grad is None:  # the loss does not reach it: zero in JAX
            np.testing.assert_array_equal(want_g[name].numpy(), 0.0, err_msg=name)
            unreached += 1
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    # the limb norms of the attention and graph modules: 2 x 4 per layer
    assert unreached == 8 * GRAD["n_layers"]
    sd = port.state_dict()
    for k in (k for k in sd if "running" in k):
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), **TOL,
                                   err_msg=k)


def test_one_adamw_step_matches_optax(one_layer, jax_grads):
    """One AdamW step of the port against optax's `adamw`: fed the JAX
    gradients, every entry within 1e-6 (decay of the parameters the loss
    does not reach included); end to end, from the port's own gradients,
    outside the entries whose gradient is below 1e-5. The first Adam step
    moves an entry by ~lr * sign(g), and the gradient check admits 1e-6 of
    absolute difference, so below that the sign is rounding noise."""
    _, params, state = one_layer
    want_g, _, _, grads = jax_grads[0]
    opt = JL.make_optimizer(JConfig(learning_rate=1e-3))
    jparams = jax.tree.map(jnp.asarray, params)
    updates, _ = jax.jit(opt.update)(grads, opt.init(jparams), jparams)
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, optax.apply_updates(jparams, updates)), state)

    fed = torch_flagship(params, state, **GRAD)
    for name, p in fed.named_parameters():
        p.grad = want_g[name].clone()
    TLP.make_optimizer(fed, Config(learning_rate=1e-3)).step()
    for name, p in fed.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)

    port, cfg, _ = _port_grads(params, state, 0, lr=1e-3)
    TLP.zero_unreached_grads(port)  # as the train step does
    TLP.make_optimizer(port, cfg).step()
    excluded = total = 0
    for name, p in port.named_parameters():
        g = want_g[name].numpy()
        keep = ~((np.abs(g) < 1e-5) & (g != 0))
        excluded += int((~keep).sum())
        total += g.size
        np.testing.assert_allclose(p.detach().numpy()[keep], want[name].numpy()[keep],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    print(f"AdamW step from the port's gradients: {excluded} of {total} "
          f"entries excluded (0 < |g| < 1e-5)")
    assert excluded < total // 100


def test_lr_schedule_matches_jax():
    for kw in (dict(learning_rate=5e-4, warmup=True, warmup_epoches=10),
               dict(learning_rate=1e-3, warmup=False)):
        for epoch in range(14):
            assert TLP.warmup_lr(Config(**kw), epoch) == JL.warmup_lr(JConfig(**kw), epoch)
    ours, theirs = TLP.ReduceLROnPlateau(0.9, 2), JL.ReduceLROnPlateau(0.9, 2)
    lr_a = lr_b = 1.0
    for metric in (10.0, 10.0, 10.0, 10.0, 5.0, 5.0, 4.9996, 6.0, 6.0, 6.0, 1.0):
        lr_a, lr_b = ours.step(metric, lr_a), theirs.step(metric, lr_b)
        assert lr_a == lr_b and ours.state_dict() == theirs.state_dict()
    assert lr_a == pytest.approx(0.9 ** 2)


def test_clipsets_and_stores_match_jax(sliced, tmp_path):
    train_d, test_d = sliced
    j_train, j_test = JC.clipsets_from_sliced(train_d, test_d)
    t_train, t_test = TC.clipsets_from_sliced(train_d, test_d)
    for a, b in ((j_train, t_train), (j_test, t_test)):
        for field in ("inputs", "labels", "labels_scaled", "factors", "actions", "res"):
            va, vb = getattr(a, field), getattr(b, field)
            assert (va is None) == (vb is None), field
            if va is not None:
                np.testing.assert_array_equal(vb, va, err_msg=field)
    # a store the JAX package wrote loads in the port, and the port's own
    # .npz and reference-pkl stores round-trip
    JC.save_clipstore(TC.clipstore_path(str(tmp_path), "J", "test"), j_test)
    TC.save_clipstore(TC.clipstore_path(str(tmp_path), "T", "test"), t_test)
    TC.write_reference_clip_files(str(tmp_path / "R"), t_test)
    for name in ("J", "T", "R"):
        got = TC.load_split(str(tmp_path), name, "test")
        np.testing.assert_array_equal(got.labels_scaled, t_test.labels_scaled)
        np.testing.assert_array_equal(got.actions, t_test.actions)
    (tmp_path / "K").mkdir()
    (tmp_path / "K" / "test.ksf").write_bytes(b"KSF1")
    with pytest.raises(NotImplementedError, match="KSF1"):
        TC.load_split(str(tmp_path), "K", "test")


def test_evaluator_matches_jax(small, sliced):
    """The eval protocol on a make_source test split within 1e-3 mm."""
    model, params, state = small
    _, test_d = sliced
    _, j_test = JC.clipsets_from_sliced(*sliced)
    _, t_test = TC.clipsets_from_sliced(*sliced)
    want = JEvaluator(model, j_test, batch_size=4, flip=True).run(params, state)
    port = torch_flagship(params, state, **SMALL)
    got = Evaluator(port, t_test, batch_size=4, flip=True).run()
    for key in ("mpjpe", "p_mpjpe", "acceleration_error", "upper_body_mpjpe",
                "lower_body_mpjpe"):
        assert abs(got[key] - want[key]) < 1e-3, key
    np.testing.assert_allclose(got["mpjpe_joint"], want["mpjpe_joint"], atol=1e-3)
    assert dict(zip(got["activity_name_sequence"], got["mpjpe_activity"])) == \
        pytest.approx(dict(zip(want["activity_name_sequence"], want["mpjpe_activity"])),
                      abs=1e-3)
    assert not port.training and "Protocol #1" in format_eval_report(got)


_TINY = dict(n_layers=1, dim_feat=32, num_heads=4, dim_rep=64)


def _trainer_config(tmp, **kw) -> Config:
    return Config(**_TINY, batch_size=8, epochs=4, learning_rate=1e-3,
                  warmup=True, warmup_epoches=1, training_epoch_patience=50,
                  eval_batch_size=16, new_checkpoint_dir=str(tmp),
                  new_checkpoint_name="m", logger_dir_path="", **kw)


def test_resume_is_bitwise_equal_to_uninterrupted(sliced, tmp_path):
    """Train 4 epochs straight; or 2, then restore the latest checkpoint
    into a fresh model and train 2 more: the same weights, bit for bit
    (per-epoch shuffles, per-step flips, restored AdamW and plateau
    state)."""
    train_set, test_set = TC.clipsets_from_sliced(*sliced)
    log = logging.getLogger("resume-test")

    def run(tmp, epochs, **fit):
        cfg = _trainer_config(tmp)
        model = build_model(cfg, device="cpu")
        if "state" in fit:
            model.load_state_dict(fit.pop("state"))
        trainer = TLP.Trainer(cfg, model, train_set, test_set, log=log)
        trainer.fit(epochs=epochs, **fit)
        return model

    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    latest = str(tmp_path / "b" / "m_latest")
    meta = TLP.load_checkpoint_meta(latest)
    assert meta["epoch"] == 2 and set(meta) == {
        "epoch", "learning_rate", "min_mpjpe", "scheduler_best",
        "scheduler_bad_epochs", "wandb_run_id"}
    payload = ckpt.restore_native(latest)
    resumed = run(tmp_path / "b", 4, state=payload["model"],
                  **TLP.resume_kwargs(meta, payload["optimizer"]))
    a, b = straight.state_dict(), resumed.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_and_evaluate_through_the_cli(sliced, tmp_path):
    """`train` for 2 epochs with --device cpu on an .npz clip store: each
    epoch evaluated, best and latest checkpoints written; `evaluate` of the
    best checkpoint gives the best epoch's MPJPE; `resume: true` goes on
    from the latest."""
    train_set, test_set = TC.clipsets_from_sliced(*sliced)
    for cs in (train_set, test_set):
        TC.save_clipstore(TC.clipstore_path(str(tmp_path / "clips"), "SP", cs.split), cs)
    config = dict(_TINY, seed=1, epochs=2, batch_size=8, learning_rate=1e-3,
                  warmup_epoches=1, data_root=str(tmp_path / "clips"),
                  clip_set_name="SP", new_checkpoint_dir=str(tmp_path / "ckpt"),
                  new_checkpoint_name="t", logger_dir_path=str(tmp_path / "log"),
                  logger_file_name="t.log")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    assert cli.main(["train", "--config-path", str(path), "--device", "cpu"]) == 0
    for tag in ("best", "latest"):
        assert (tmp_path / "ckpt" / f"t_{tag}" / "step_0" / "model.pth").exists()
    logs = "".join(p.read_text() for p in (tmp_path / "log").iterdir())
    mpjpes = [float(line.split("MPJPE ")[1].split(" mm")[0])
              for line in logs.splitlines() if ": MPJPE " in line]
    assert len(mpjpes) == 2
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["evaluate", "--config-path", str(path), "--device", "cpu",
                         "--checkpoint", str(tmp_path / "ckpt" / "t_best")]) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert abs(result["mpjpe"] - min(mpjpes)) < 1e-3
    # resume from the latest checkpoint for a third epoch
    path.write_text(json.dumps(dict(
        config, epochs=3, checkpoint=True, resume=True,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_file_name="t_latest")))
    assert cli.main(["train", "--config-path", str(path), "--device", "cpu"]) == 0
    assert TLP.load_checkpoint_meta(str(tmp_path / "ckpt" / "t_latest"))["epoch"] == 3
    # the native model file is a reference .pth that loads on its own
    sd = ckpt.load_torch_checkpoint(
        str(tmp_path / "ckpt" / "t_best" / "step_0" / "model.pth"))
    assert set(sd) == set(build_model(Config(**_TINY), device="cpu").state_dict())


def test_train_cli_refuses_a_missing_card(tmp_path):
    """Without --device the trainer runs on the card, and raises without
    one rather than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(_TINY, data_root=str(tmp_path), clip_set_name="X")))
    (tmp_path / "X").mkdir()
    for split in ("train", "test"):
        x = np.zeros((2, 27, 17, 3), np.float32)
        TC.save_clipstore(str(tmp_path / "X" / f"{split}.npz"), TC.ClipSet(
            split, x, x, labels_scaled=x, factors=np.ones((2, 27), np.float32),
            actions=np.array(["a", "a"]), res=np.ones((2, 2), np.float32)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--config-path", str(path)])
