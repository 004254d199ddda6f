"""The port's trainer against the JAX trainer, on the CPU.

Both packages run in one process on the same initial weights (JAX's, carried
across with ``from_flax_variables``) and the same rows.  The JAX side runs
``train_step`` and ``eval_step`` under ``jax.jit`` on one device, and its
``Trainer`` on a one-device mesh (conftest gives JAX 8 virtual devices).
With noise and dropout at 0 and rows exactly ``input_length`` long, JAX's
crop offset is 0 and nothing in a step is random.  Bounds: the loss within
1e-5, every gradient within atol 1e-5 + rtol 1e-4, the new batch
statistics within 1e-5, the optimiser's parameters and moments within 1e-6;
whole steps are held by their losses (1e-4), because Adam's first steps turn
rounding in near-zero gradients into visible parameter differences.
"""

import dataclasses
import functools
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepbinner_tpu.models.checkpoint import load_model as jax_load_model
from deepbinner_tpu.models.network import NetworkConfig as JaxNetworkConfig
from deepbinner_tpu.parallel import mesh as mesh_lib
from deepbinner_tpu.train import trainer as jax_trainer
from deepbinner_tpu_torch.models.checkpoint import (
    from_flax_variables,
    load_model,
    model_from_flax_variables,
)
from deepbinner_tpu_torch.models.network import DemuxNet, NetworkConfig, init_weights
from deepbinner_tpu_torch.train import data as data_io
from deepbinner_tpu_torch.train import prep as prep_mod
from deepbinner_tpu_torch.train import trainer as port_trainer
from deepbinner_tpu_torch.utils import simulate

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _quiet(jax_cfg: JaxNetworkConfig) -> JaxNetworkConfig:
    return dataclasses.replace(jax_cfg, noise_stddev=0.0, dropout_rate=0.0)


def _port_config(jax_cfg: JaxNetworkConfig) -> NetworkConfig:
    fields = dataclasses.asdict(jax_cfg)
    fields.pop("compute_dtype")
    return NetworkConfig(**fields)


TINY = _quiet(jax_trainer.TINY_PRESET)
FULL = _quiet(JaxNetworkConfig())


def _batch(seed, batch, length, zero_rows=2):
    rng = np.random.default_rng(seed)
    signals = rng.normal(450.0, 60.0, (batch, length)).astype(np.float32)
    labels = rng.integers(0, 13, batch).astype(np.int32)
    weights = np.ones(batch, np.float32)
    weights[batch - zero_rows:] = 0.0  # padding rows: out of the loss, in BN
    return signals, labels, weights


def _jax_step_and_grads(jax_cfg, seed, batch):
    """JAX's initial state, one jitted train_step on a batch, and jax.grad
    of the same loss."""
    cfg = jax_trainer.TrainConfig(network=jax_cfg, batch_size=batch)
    model, state = jax_trainer.init_train_state(jax.random.PRNGKey(seed), cfg)
    tx = jax_trainer.make_optimizer(cfg)
    window = jax_cfg.input_length
    signals, labels, weights = _batch(seed, batch, window)
    rng = jax.random.PRNGKey(seed + 100)
    step = jax.jit(functools.partial(jax_trainer.train_step, model, tx, window))
    new_state, metrics = step(state, jnp.asarray(signals), jnp.asarray(labels),
                              jnp.asarray(weights), rng)
    # The same loss as train_step's: rows of input_length crop at offset 0.
    crops = jax_trainer.augment_crop(jnp.asarray(signals), window, rng)

    def loss_fn(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            crops[:, :, None], train=True, mutable=["batch_stats"])
        per = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels))
        return (per * weights).sum() / max(weights.sum(), 1.0)

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    initial = {"params": jax.device_get(state.params),
               "batch_stats": jax.device_get(state.batch_stats)}
    return (initial, (signals, labels, weights), jax.device_get(grads),
            jax.device_get(new_state), float(metrics["loss"]),
            float(metrics["accuracy"]))


def _tensors(signals, labels, weights):
    return (torch.from_numpy(signals), torch.from_numpy(labels).long(),
            torch.from_numpy(weights))


def _check_step(jax_cfg, seed, batch):
    initial, rows, grads, new_state, jax_loss, jax_acc = _jax_step_and_grads(
        jax_cfg, seed, batch)
    cfg = _port_config(jax_cfg)
    model = model_from_flax_variables(cfg, initial)
    signals, labels, weights = _tensors(*rows)
    crops = port_trainer.augment_crop(signals, cfg.input_length,
                                      offsets=np.zeros(len(labels), np.int64))
    loss, accuracy = port_trainer.forward_backward(model, crops, labels, weights)
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5, atol=1e-5)
    assert float(accuracy) == pytest.approx(jax_acc, abs=1e-6)
    want = from_flax_variables(cfg, {"params": grads,
                                     "batch_stats": new_state.batch_stats})
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, buffer in model.named_buffers():
        np.testing.assert_allclose(buffer.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


# -- (a) one step's loss, gradients and batch statistics ----------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax_grad_and_batch_stats(seed):
    _check_step(TINY, seed, batch=16)


# -- (h) the same at the flagship width --------------------------------------

def test_flagship_width_step_matches_jax():
    _check_step(FULL, 0, batch=4)


# -- (b) clipping and AdamW on JAX's gradients ---------------------------------

def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no ScaleByAdamState in the optax state")


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 300.0])  # below and above clip
def test_optimizer_matches_optax(grad_scale):
    initial, _rows, grads, _new, _loss, _acc = _jax_step_and_grads(TINY, 3, 8)
    jcfg = jax_trainer.TrainConfig(network=TINY)
    tx = jax_trainer.make_optimizer(jcfg)
    params = initial["params"]
    opt_state = tx.init(params)
    cfg = _port_config(TINY)
    model = model_from_flax_variables(cfg, initial)
    optimizer = port_trainer.make_optimizer(
        port_trainer.TrainConfig(network=cfg), model.parameters())
    stats = initial["batch_stats"]
    for step in range(3):
        step_grads = jax.tree_util.tree_map(
            lambda g: g * grad_scale * (1.0 + 0.5 * step), grads)
        updates, opt_state = tx.update(step_grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        mapped = from_flax_variables(cfg, {"params": step_grads,
                                           "batch_stats": stats})
        for name, param in model.named_parameters():
            param.grad = mapped[name].clone()
        port_trainer.clip_by_global_norm_([p.grad for p in model.parameters()])
        optimizer.step()
        adam = _adam_state(opt_state)
        for tree, attr in ((params, None), (adam.mu, "exp_avg"),
                           (adam.nu, "exp_avg_sq")):
            want = from_flax_variables(cfg, {"params": jax.device_get(tree),
                                             "batch_stats": stats})
            for name, param in model.named_parameters():
                got = param if attr is None else optimizer.state[param][attr]
                np.testing.assert_allclose(
                    got.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                    err_msg=f"step {step} {attr or 'param'} {name}")
        assert int(adam.count) == step + 1


def test_clip_is_optax_rule():
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    port_trainer.clip_by_global_norm_(grads)  # norm 5 → g / 5
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.array([3.0, 4.0]), jnp.array([0.0])], None)[0]
    for got, ref in zip(grads, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    small = [torch.tensor([0.3, 0.4])]
    port_trainer.clip_by_global_norm_(small)  # norm 0.5: unchanged
    np.testing.assert_array_equal(small[0].numpy(), np.float32([0.3, 0.4]))


# -- (c) five whole steps through both Trainers -------------------------------

def test_five_trainer_steps_match_jax_losses():
    jcfg = jax_trainer.TrainConfig(network=TINY, batch_size=16, seed=4)
    jax_side = jax_trainer.Trainer(jcfg, mesh_lib.make_mesh(jax.devices()[:1]))
    cfg = _port_config(TINY)
    port_side = port_trainer.Trainer(
        port_trainer.TrainConfig(network=cfg, batch_size=16, seed=4), "cpu")
    port_side.model.load_state_dict(
        from_flax_variables(cfg, jax_side.export_variables()))
    for step in range(5):
        signals, labels, weights = _batch(50 + step, 16, cfg.input_length)
        want = jax_side.run_train_step(signals, labels, weights)
        got = port_side.run_train_step(signals, labels, weights)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   atol=1e-4, rtol=0, err_msg=f"step {step}")
    assert port_side.step == int(np.asarray(jax_side.state.step)) == 5


# -- eval_step and Trainer.run_eval -------------------------------------------

def test_eval_matches_jax():
    jcfg = jax_trainer.TrainConfig(network=TINY, seed=7)
    jax_side = jax_trainer.Trainer(jcfg, mesh_lib.make_mesh(jax.devices()[:1]))
    cfg = _port_config(TINY)
    variables = jax_side.export_variables()
    model = model_from_flax_variables(cfg, variables)
    rng = np.random.default_rng(8)
    signals = rng.normal(450.0, 60.0, (37, 400)).astype(np.float32)
    labels = rng.integers(0, 13, 37).astype(np.int32)
    want = jax.jit(functools.partial(jax_trainer.eval_step, jax_side.model,
                                     cfg.input_length))(
        jax_side.state, jnp.asarray(signals), jnp.asarray(labels))
    got = port_trainer.eval_step(model, cfg.input_length,
                                 *_tensors(signals, labels, labels)[:2])
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["correct"].numpy(),
                                  np.asarray(want["correct"]))
    port_side = port_trainer.Trainer(
        port_trainer.TrainConfig(network=cfg, seed=7), "cpu")
    port_side.model.load_state_dict(from_flax_variables(cfg, variables))
    jax_eval = jax_side.run_eval(signals, labels, batch=16)
    port_eval = port_side.run_eval(signals, labels, batch=16)
    assert port_eval["loss"] == pytest.approx(jax_eval["loss"], abs=1e-5)
    assert port_eval["accuracy"] == pytest.approx(jax_eval["accuracy"], abs=1e-7)


# -- (d) augment_crop with JAX's offsets ---------------------------------------

@pytest.mark.parametrize("size,window", [(256, 256), (400, 256), (1536, 1024)])
def test_augment_crop_matches_jax(size, window):
    """The crop is JAX's dynamic_slice exactly; the z-scored crop agrees
    within 1e-6 on rows of DAC integers, which is what the trainer is given
    (``load_training_set`` reads int16 samples)."""
    rng = np.random.default_rng(size)
    signals = np.round(rng.normal(450.0, 60.0, (9, size))).astype(np.float32)
    key = jax.random.PRNGKey(size)
    offsets = np.array(jax.random.randint(key, (9,), 0, size - window + 1))
    want_crop = np.stack([np.asarray(jax.lax.dynamic_slice(row, (off,), (window,)))
                          for row, off in zip(signals, offsets)])
    gathered = torch.gather(torch.from_numpy(signals), 1,
                            torch.from_numpy(offsets).long()[:, None]
                            + torch.arange(window))
    np.testing.assert_array_equal(gathered.numpy(), want_crop)
    want = np.asarray(jax_trainer.augment_crop(jnp.asarray(signals), window, key))
    got = port_trainer.augment_crop(torch.from_numpy(signals), window,
                                    offsets=offsets).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    centre = port_trainer.center_crop(torch.from_numpy(signals), window).numpy()
    np.testing.assert_allclose(
        centre, np.asarray(jax_trainer.center_crop(jnp.asarray(signals), window)),
        atol=1e-6, rtol=0)


def test_augment_crop_draws_in_range_and_repeats_per_step():
    size, window = 300, 256
    signals = torch.randn(20, size, generator=torch.Generator().manual_seed(0))
    crops = []
    for _ in range(2):
        gen = port_trainer.step_generator(1, 5, torch.device("cpu"))
        crops.append(port_trainer.augment_crop(signals, window, gen))
    assert torch.equal(crops[0], crops[1])  # a function of (seed, step)
    other = port_trainer.augment_crop(
        signals, window, port_trainer.step_generator(1, 6, torch.device("cpu")))
    assert not torch.equal(crops[0], other)
    starts = []
    for row, crop in zip(signals, crops[0]):
        hits = [o for o in range(size - window + 1) if torch.equal(
            port_trainer.center_crop(row[None, o : o + window], window)[0], crop)]
        assert len(hits) == 1
        starts.extend(hits)
    assert len(set(starts)) > 1


# -- (e) batches and the split: the JAX loop's draws ---------------------------

@pytest.mark.parametrize("n,batch_size", [(10, 4), (8, 8), (3, 8), (17, 5)])
def test_epoch_batches_match_jax(n, batch_size):
    order = np.random.default_rng(n).permutation(n)
    got = list(port_trainer.iter_epoch_batches(
        order, batch_size, rng=np.random.default_rng(1)))
    want = list(jax_trainer.iter_epoch_batches(
        order, batch_size, rng=np.random.default_rng(1)))
    assert len(got) == len(want)
    seen = []
    for (g_idx, g_w), (w_idx, w_w) in zip(got, want):
        np.testing.assert_array_equal(g_idx, w_idx)
        np.testing.assert_array_equal(g_w, w_w)
        seen.extend(g_idx[g_w > 0].tolist())
    assert sorted(seen) == sorted(order.tolist())  # each index once


class _Recorder:
    """A trainer stub for either loop: records the rows it is handed."""

    data_parallelism = 1

    def __init__(self):
        self.batches, self.evals = [], []

    def run_train_step(self, signals, labels, weights):
        self.batches.append((np.asarray(labels).copy(),
                             np.asarray(weights).copy()))
        return {"loss": torch.tensor(0.0)}

    def run_eval(self, signals, labels):
        self.evals.append(np.asarray(labels).copy())
        return {"loss": 0.0, "accuracy": 0.0}

    def export_variables(self):
        return {}


@pytest.mark.parametrize("seed,n,batch_size,aug", [(0, 50, 8, 2), (3, 37, 16, 1)])
def test_train_loop_draws_match_jax(seed, n, batch_size, aug):
    signals = np.zeros((n, 4), np.float32)
    labels = np.arange(n, dtype=np.int32)  # a row's label is its index
    runs = {}
    for name, module in (("jax", jax_trainer), ("port", port_trainer)):
        recorder = _Recorder()
        module.train_loop(recorder, signals, labels, epochs=3,
                          batch_size=batch_size, test_fraction=0.2,
                          aug_factor=aug, seed=seed, log_every=100)
        runs[name] = recorder
    assert len(runs["port"].batches) == len(runs["jax"].batches)
    for (g_idx, g_w), (w_idx, w_w) in zip(runs["port"].batches,
                                          runs["jax"].batches):
        np.testing.assert_array_equal(g_idx, w_idx)
        np.testing.assert_array_equal(g_w, w_w)
    for got, want in zip(runs["port"].evals, runs["jax"].evals):
        np.testing.assert_array_equal(got, want)  # the validation split


# -- (f) resume: the R4 repair --------------------------------------------------

class _RecordingTrainer(port_trainer.Trainer):
    def run_train_step(self, signals, labels, weights=None, offsets=None):
        metrics = super().run_train_step(signals, labels, weights, offsets)
        self.record.append((np.asarray(signals).copy(), float(metrics["loss"])))
        return metrics


def _small_rows(n=60, size=300):
    rng = np.random.default_rng(11)
    return (rng.normal(450.0, 60.0, (n, size)).astype(np.float32),
            rng.integers(0, 13, n).astype(np.int32))


def test_resume_equals_uninterrupted_run_bit_for_bit(tmp_path):
    """Stopped after epoch 2 of 4 and resumed, the run is the uninterrupted
    one, bit for bit: the same batches, losses, steps and weights.  (The JAX
    loop differs here: it draws the resumed epochs' batches from the first
    epoch's draws again, fault R4.)"""
    signals, labels = _small_rows()
    cfg = port_trainer.TrainConfig(network=_port_config(jax_trainer.TINY_PRESET),
                                   batch_size=16, seed=2)
    loop = dict(batch_size=16, test_fraction=0.2, aug_factor=2, seed=2,
                log_every=100)

    def trainer():
        made = _RecordingTrainer(cfg, "cpu")
        made.record = []
        return made

    whole = trainer()
    port_trainer.train_loop(whole, signals, labels, epochs=4, **loop)
    first = trainer()
    ckpt = str(tmp_path / "ckpt")
    port_trainer.train_loop(first, signals, labels, epochs=2,
                            checkpoint_dir=ckpt, **loop)
    resumed = trainer()
    port_trainer.train_loop(resumed, signals, labels, epochs=4, resume=ckpt,
                            **loop)
    steps_per_epoch = len(whole.record) // 4
    assert len(first.record) == 2 * steps_per_epoch
    tail = whole.record[2 * steps_per_epoch:]
    assert len(resumed.record) == len(tail)
    for (got_rows, got_loss), (want_rows, want_loss) in zip(resumed.record, tail):
        np.testing.assert_array_equal(got_rows, want_rows)
        assert got_loss == want_loss
    assert resumed.step == whole.step == 4 * steps_per_epoch
    got, want = resumed.model.state_dict(), whole.model.state_dict()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for param_got, param_want in zip(resumed.model.parameters(),
                                     whole.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed.optimizer.state[param_got][key],
                               whole.optimizer.state[param_want][key]), key


def test_checkpoint_restores_step_and_moments(tmp_path):
    signals, labels = _small_rows(30)
    cfg = port_trainer.TrainConfig(network=_port_config(jax_trainer.TINY_PRESET),
                                   batch_size=8, epochs=1, seed=1)
    trainer = port_trainer.Trainer(cfg, "cpu")
    port_trainer.train_loop(trainer, signals, labels, epochs=1, batch_size=8,
                            test_fraction=0.2, aug_factor=1, seed=1,
                            checkpoint_dir=str(tmp_path), log_every=100)
    meta = (tmp_path / "meta.json").read_text()
    assert '"epoch": 0' in meta and f'"step": {trainer.step}' in meta
    assert sorted(p.name for p in tmp_path.iterdir()) == ["meta.json", "state.pt"]
    again = port_trainer.Trainer(cfg, "cpu")
    assert again.restore_checkpoint(str(tmp_path)) == 0
    assert again.step == trainer.step
    for got, want in zip(again.model.parameters(), trainer.model.parameters()):
        assert torch.equal(got, want)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(again.optimizer.state[got][key],
                               trainer.optimizer.state[want][key])


# -- initialisation and the training forward -----------------------------------

def test_init_weights_follow_flax_distributions():
    cfg = _port_config(FULL)
    model = init_weights(DemuxNet(cfg), torch.Generator().manual_seed(0))
    again = init_weights(DemuxNet(cfg), torch.Generator().manual_seed(0))
    _jax_model, jax_state = jax_trainer.init_train_state(
        jax.random.PRNGKey(0), jax_trainer.TrainConfig(network=FULL))
    jax_vars = jax.device_get(jax_state)
    want = from_flax_variables(cfg, {"params": jax_vars.params,
                                     "batch_stats": jax_vars.batch_stats})
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, again.state_dict()[name]), name
        ref = want[name]
        assert tensor.shape == ref.shape, name
        if name.endswith(("kernel", "weight")):
            fan_in = tensor.shape[1] if name.endswith("weight") else (
                tensor.shape[0] * tensor.shape[1])
            std = fan_in ** -0.5
            bound = 2 * std / 0.87962566103423978
            assert float(tensor.abs().max()) <= bound * (1 + 1e-6), name
            assert float(np.abs(ref.numpy()).max()) <= bound * (1 + 1e-6), name
            if tensor.numel() >= 4000:  # enough draws to see the variance
                assert float(tensor.std()) == pytest.approx(std, rel=0.05), name
                assert float(ref.std()) == pytest.approx(std, rel=0.05), name
        else:
            assert torch.equal(tensor, ref), name  # zeros and ones


def test_training_forward_needs_a_generator_for_noise():
    model = init_weights(DemuxNet(_port_config(jax_trainer.TINY_PRESET)),
                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        model(torch.zeros(2, 256), train=True)


def test_module_training_flag_does_not_change_inference():
    model = init_weights(DemuxNet(_port_config(TINY)),
                         torch.Generator().manual_seed(5))
    x = torch.randn(3, 256, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        model.train()
        as_training = model(x)
        model.eval()
        as_eval = model(x)
    assert torch.equal(as_training, as_eval)
    assert torch.equal(model.stem1.mean, torch.zeros(8))  # untouched


# -- (g) train through the port's CLI -------------------------------------------

@pytest.fixture(scope="module")
def tiny_training_set():
    """The JAX tests' fixture (tests/test_train.py), built with the port's
    simulator and prep: 12 barcodes + none, tiny windows."""
    rng = np.random.default_rng(5)
    rows = []
    for barcode in range(0, 13):
        for _ in range(16 if barcode else 32):
            read = simulate.simulate_read(
                "EXP-NBD103", barcode, rng, genome_length=200,
                open_pore_length=50,
            )
            move = (read.signal_start_of_bases, read.dwells)
            samples = prep_mod.extract_training_samples(
                read.signal, read.sequence, move, "EXP-NBD103", "start",
                signal_size=512, margin=64,
            )
            for label, signal in samples:
                if (label == 0) == (barcode == 0):
                    rows.append((label, signal))
    return rows


def test_cli_train_tiny_on_the_cpu_beats_chance(tiny_training_set, tmp_path):
    from deepbinner_tpu_torch.cli.main import main

    data = tmp_path / "train.tsv"
    data_io.write_samples(data, tiny_training_set)
    out = tmp_path / "tiny.dbt"
    main(["train", str(data), "--out", str(out), "--size", "tiny",
          "--device", "cpu", "--epochs", "20", "--batch_size", "32",
          "--learning_rate", "3e-3", "--test_fraction", "0.15",
          "--aug_factor", "4", "--checkpoint_dir", str(tmp_path / "ckpt")])
    _model, cfg, meta = load_model(out)
    assert cfg == _port_config(jax_trainer.TINY_PRESET)
    assert meta["epochs"] == 20
    assert meta["best_val"]["accuracy"] > 0.4  # chance is ~1/13 ≈ 0.077
    # The JAX package reads the trained model.
    _jmodel, _variables, jax_cfg, jax_meta = jax_load_model(out)
    assert jax_cfg == jax_trainer.TINY_PRESET and jax_meta == meta
    with zipfile.ZipFile(out) as archive:
        assert sorted(archive.namelist()) == ["config.json", "params.msgpack"]


def test_cli_train_refuses_data_parallel(tmp_path, capsys, monkeypatch):
    """``--dp`` above the cards present is refused before any rank starts
    (one card is made to show here; data-parallel training itself:
    tests/test_torch_dist_train.py)."""
    from deepbinner_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        main(["train", str(tmp_path / "none.tsv"), "--out",
              str(tmp_path / "m.dbt"), "--dp", "2"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--dp 2 exceeds the 1 card(s) present" in err
    assert "data-parallel:" not in err  # no rank was started
    assert not (tmp_path / "m.dbt").exists()


def test_train_from_args_rejects_short_rows(tmp_path, capsys):
    data = tmp_path / "short.tsv"
    data_io.write_samples(data, [(1, np.arange(256, dtype=np.int16))] * 4)
    args = types.SimpleNamespace(
        training_data=str(data), out=str(tmp_path / "m.dbt"), size="tiny",
        device="cpu", dp=0, epochs=1, batch_size=2, learning_rate=1e-3,
        test_fraction=0.25, aug_factor=1, seed=0, checkpoint_dir=None,
        resume=None)
    with pytest.raises(SystemExit):
        port_trainer.train_from_args(args)
    assert "must be longer" in capsys.readouterr().err
