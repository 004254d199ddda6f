"""`train`: DemuxNet training with in-step augmentation, on one device or
data parallel over several ranks.

Counterpart of ``deepbinner_tpu/train/trainer.py``.  The host ships raw
``(B, signal_size)`` rows; each step crops every row at a random offset to
the network's input, z-scores the crop, and runs the training forward
(GaussianNoise, BatchNorm on the batch statistics, dropout), the weighted
cross-entropy, global-norm clipping and AdamW.

What differs from the JAX trainer:

- Randomness: each step draws its crop offsets, noise and dropout, in that
  order, from a ``torch.Generator`` seeded from ``(seed + 1, step)``, the
  counterpart of ``fold_in(PRNGKey(seed + 1), step)``.  So a resumed run
  needs no saved generator state.  The draws cannot equal JAX's.
- Initial weights come from :func:`~deepbinner_tpu_torch.models.network.init_weights`
  (flax's distributions, another generator).
- Data parallelism is one process per device (PyTorch's idiom), where
  the JAX trainer jits one step over a mesh.  ``train --dp N`` starts N
  ranks on this host; a process launched with ``WORLD_SIZE`` above 1 is one
  rank of a job that may span hosts.  Every rank holds the same global
  batch (the same TSV and seeded epoch order) and takes its rows of it
  (:class:`~deepbinner_tpu_torch.parallel.dist.RowShard`).  The step's draws
  are made at the global batch's shape, BatchNorm's statistics, the loss
  denominator and the gradients are summed over the ranks, so a step is
  the one-process step on the global batch, up to the order of its sums;
  clip and AdamW then run alike on every rank.  Only rank 0 writes
  checkpoints and the ``.dbt``.
- Resume replays the host draws of the epochs already trained (fault R4
  of the JAX loop, which draws them again from the first epoch's).
- Checkpoints hold the port's own state file (``state.pt``: the model's
  and the optimiser's state dicts and the step) beside the JAX trainer's
  ``meta.json``.

Every train and eval step runs inside :func:`pinned`: no TF32 in cuBLAS or
cuDNN (``runner.pipeline.full_f32``) and cuDNN's deterministic algorithms,
whatever the process has set.  So a step gives the same bits every time on
the card too, and a resumed run there repeats the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepbinner_tpu_torch import NUM_CLASSES, resolve_device
from deepbinner_tpu_torch.models.checkpoint import save_model, to_flax_variables
from deepbinner_tpu_torch.models.network import DemuxNet, NetworkConfig, init_weights
from deepbinner_tpu_torch.ops.preprocess import normalise
from deepbinner_tpu_torch.parallel import dist, mesh
from deepbinner_tpu_torch.parallel.dist import RowShard
from deepbinner_tpu_torch.runner.pipeline import full_f32
from deepbinner_tpu_torch.train import data as data_io
from deepbinner_tpu_torch.utils.log import log, quit_with_error, section

CLIP_NORM = 1.0
WEIGHT_DECAY = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    network: NetworkConfig
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 100
    test_fraction: float = 0.1
    aug_factor: int = 2
    seed: int = 0


@contextlib.contextmanager
def pinned() -> Iterator[None]:
    """TF32 off and cuDNN deterministic inside; the caller's settings after.

    cuDNN's default backward algorithms sum in another order from run to
    run, and two runs of one seed then drift apart within a few epochs.  On
    an H100 the deterministic ones take a flagship step at batch 256 from
    about 25 to about 45 ms (``chip_smoke.py``'s ``train`` line,
    ``step_variants``; ``PERF.md``).
    """
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_f32():
            yield
    finally:
        torch.backends.cudnn.deterministic = deterministic


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """optax's ``adamw(lr, weight_decay=1e-5)`` over every parameter; the
    clipping before it is :func:`clip_by_global_norm_`."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WEIGHT_DECAY)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float = CLIP_NORM) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    each gradient stays as it is where the global norm is below
    ``max_norm``, else becomes ``g / norm * max_norm``.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.)"""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step, a function of ``(seed, step)`` alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def augment_crop(signals: torch.Tensor, window: int,
                 generator: Optional[torch.Generator] = None,
                 offsets=None, shard: Optional[RowShard] = None) -> torch.Tensor:
    """Crop each row to ``window`` samples at a random offset in
    ``[0, size - window]``, then z-score the crop.  ``offsets`` (one per row)
    replaces the draw, so that a test can hand in JAX's.  Under ``shard``
    the offsets (drawn or given) are the global batch's, cut to this rank's
    rows."""
    batch, size = signals.shape
    if offsets is None:
        rows = batch if shard is None else shard.total
        offsets = torch.randint(0, size - window + 1, (rows,),
                                generator=generator, device=signals.device)
    offsets = torch.as_tensor(offsets, device=signals.device).long()
    if shard is not None:
        offsets = offsets[shard.rows]
    index = offsets[:, None] + torch.arange(window, device=signals.device)
    return normalise(torch.gather(signals, 1, index))


def center_crop(signals: torch.Tensor, window: int) -> torch.Tensor:
    start = (signals.shape[1] - window) // 2
    return normalise(signals[:, start : start + window])


def forward_backward(
    model: DemuxNet,
    crops: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    shard: Optional[RowShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss Σ(CE·w) / max(Σw, 1) on ``crops`` (z-scored windows) and its
    gradients (into ``.grad``), and the weighted accuracy.  Rows of weight 0
    still enter the BatchNorm statistics, as in the JAX step.  Under
    ``shard`` the rows are one rank's: Σw, the gradients and both metrics
    are summed over the ranks, so every rank ends with the global batch's."""
    weight_sum = weights.sum()
    if shard is not None:
        weight_sum = dist.all_sum(weight_sum)
    denom = torch.clamp(weight_sum, min=1.0)
    logits = model(crops, train=True, generator=generator, shard=shard)
    per_example = F.cross_entropy(logits, labels, reduction="none")
    loss = (per_example * weights).sum() / denom
    loss.backward()
    correct = (logits.detach().argmax(dim=-1) == labels).to(weights.dtype)
    accuracy = (correct * weights).sum() / denom
    if shard is None:
        return loss.detach(), accuracy
    dist.all_sum_([p.grad for p in model.parameters()])
    loss, accuracy = dist.all_sum(torch.stack([loss.detach(), accuracy]))
    return loss, accuracy


def train_step(
    model: DemuxNet,
    optimizer: torch.optim.Optimizer,
    window: int,
    signals: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    offsets=None,
    shard: Optional[RowShard] = None,
) -> Dict[str, torch.Tensor]:
    """One optimiser step; ``weights`` (0/1 per row) masks padding rows.

    The final batch of an epoch is padded to the batch size with weight-0
    rows (:func:`iter_epoch_batches`), so no sample is dropped.  The
    generator gives the crop offsets (unless ``offsets`` is given), then
    the noise, then the dropout mask.  Under ``shard`` the rows are this
    rank's of the global batch.
    """
    optimizer.zero_grad(set_to_none=True)
    crops = augment_crop(signals, window, generator, offsets, shard)
    loss, accuracy = forward_backward(model, crops, labels, weights, generator,
                                      shard)
    clip_by_global_norm_([p.grad for p in model.parameters()])
    optimizer.step()
    return {"loss": loss, "accuracy": accuracy}


def eval_step(model: DemuxNet, window: int, signals: torch.Tensor,
              labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-example loss and correct vectors on the centre crop, with the
    running statistics."""
    with torch.no_grad():
        logits = model(center_crop(signals, window))
        loss = F.cross_entropy(logits, labels, reduction="none")
        correct = (logits.argmax(dim=-1) == labels).float()
    return {"loss": loss, "correct": correct}


def _write_atomic(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    write(tmp)
    os.replace(tmp, path)


class Trainer:
    """The model, its optimiser and the step count on one device; rank
    ``rank`` of ``world`` of a data-parallel run (one process per device)
    where ``world`` is above 1."""

    def __init__(self, cfg: TrainConfig, device=None, rank: int = 0,
                 world: int = 1) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank = rank
        self.world = world
        model = init_weights(DemuxNet(cfg.network),
                             torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.step = 0
        self._data_seed = cfg.seed + 1

    def _put(self, array, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device, dtype)

    def _shard(self, total: int) -> Optional[RowShard]:
        return RowShard(self.rank, self.world, total) if self.world > 1 else None

    def run_train_step(self, signals, labels, weights=None,
                       offsets=None) -> Dict[str, torch.Tensor]:
        """One step on the global batch's host rows (this rank's are cut
        from them); the metrics stay on the device."""
        if weights is None:
            weights = np.ones((len(labels),), np.float32)
        shard = self._shard(len(labels))
        rows = slice(None) if shard is None else shard.rows
        generator = step_generator(self._data_seed, self.step, self.device)
        with pinned():
            metrics = train_step(
                self.model, self.optimizer, self.cfg.network.input_length,
                self._put(signals[rows], torch.float32),
                self._put(labels[rows], torch.long),
                self._put(weights[rows], torch.float32), generator, offsets,
                shard)
        self.step += 1
        return metrics

    def run_eval(self, signals: np.ndarray, labels: np.ndarray,
                 batch: int = 512) -> Dict[str, float]:
        """Mean loss and accuracy on the centre crops.  With several ranks
        each eval batch is padded to a multiple of them, each rank takes its
        rows, and the totals, padding left out, are summed over the ranks."""
        totals = {"loss": 0.0, "accuracy": 0.0}
        window = self.cfg.network.input_length
        with pinned():
            for start in range(0, len(labels), batch):
                sig = signals[start : start + batch]
                lab = labels[start : start + batch]
                keep, rows = len(lab), slice(None)
                if self.world > 1:
                    sig = mesh.pad_to_multiple(sig, self.world)
                    lab = mesh.pad_to_multiple(lab, self.world)
                    rows = RowShard(self.rank, self.world, len(lab)).rows
                    keep = max(0, min(rows.stop, keep) - rows.start)
                metrics = eval_step(self.model, window,
                                    self._put(sig[rows], torch.float32),
                                    self._put(lab[rows], torch.long))
                # Rows past `keep` are padding, left out of the totals.
                totals["loss"] += float(metrics["loss"][:keep].sum())
                totals["accuracy"] += float(metrics["correct"][:keep].sum())
        if self.world > 1:
            summed = dist.all_sum(torch.tensor(
                [totals["loss"], totals["accuracy"]], dtype=torch.float64))
            totals = {"loss": float(summed[0]), "accuracy": float(summed[1])}
        return {k: v / max(len(labels), 1) for k, v in totals.items()}

    # -- checkpoint / resume ------------------------------------------------

    def save_checkpoint(self, directory: str, epoch: int) -> None:
        """Write the state (rank 0 only: every rank holds the same)."""
        if self.rank != 0:
            return
        os.makedirs(directory, exist_ok=True)
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(), "step": self.step}
        _write_atomic(os.path.join(directory, "state.pt"),
                      lambda tmp: torch.save(state, tmp))

        def write_meta(tmp: str) -> None:
            with open(tmp, "w") as handle:
                json.dump({"epoch": epoch, "step": self.step}, handle)

        _write_atomic(os.path.join(directory, "meta.json"), write_meta)

    def restore_checkpoint(self, directory: str) -> int:
        """Load ``directory``'s state; returns the epoch it was saved after."""
        state = torch.load(os.path.join(directory, "state.pt"),
                           map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        # Moments go to the parameters' device; Adam's step counts stay on
        # the CPU, where the non-fused AdamW keeps them.
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        with open(os.path.join(directory, "meta.json")) as handle:
            return int(json.load(handle)["epoch"])

    def export_variables(self) -> dict:
        """The flax variables tree (numpy) of the current weights."""
        return to_flax_variables(self.model)


def iter_epoch_batches(epoch_order: np.ndarray, batch_size: int,
                       rng: Optional[np.random.Generator] = None):
    """Yield (indices, weights) batches covering every index exactly once.

    The final partial batch is padded to `batch_size` with weight-0 rows —
    one compiled batch shape, no dropped samples.  Padding rows are drawn
    at random from the epoch (not one repeated index): weight 0 masks them
    out of the loss, but BatchNorm's batch statistics still see every row,
    and a single sample repeated batch_size-1 times would skew the running
    stats; a random resample keeps them representative.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    for start in range(0, len(epoch_order), batch_size):
        idx = epoch_order[start : start + batch_size]
        weights = np.ones((batch_size,), np.float32)
        if len(idx) < batch_size:
            pad = batch_size - len(idx)
            weights[len(idx):] = 0.0
            filler = rng.choice(epoch_order, size=pad)
            idx = np.concatenate([idx, filler])
        yield idx, weights


def train_loop(
    trainer: Trainer,
    signals: np.ndarray,
    labels: np.ndarray,
    epochs: int,
    batch_size: int,
    test_fraction: float,
    aug_factor: int,
    seed: int,
    checkpoint_dir: Optional[str] = None,
    resume: Optional[str] = None,
    log_every: int = 1,
) -> Tuple[Dict[str, float], dict]:
    """Host epoch loop: shuffle, batch, step; eval per epoch; checkpoints.

    The numpy draws are the JAX loop's, in the same order, so a seed gives
    the same validation split and the same batches.  Returns the best
    epoch's validation metrics (ties go to the later epoch) and its
    variables.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    n_val = max(1, int(len(labels) * test_fraction)) if test_fraction > 0 else 0
    val_idx, train_idx = order[:n_val], order[n_val:]
    if len(train_idx) == 0:
        raise ValueError("no training samples after validation split")

    start_epoch = 0
    if resume:
        start_epoch = trainer.restore_checkpoint(resume) + 1
        log(f"  resumed from {resume} at epoch {start_epoch}")
        # Replay the draws of the epochs already trained, so that the run
        # goes on with the uninterrupted run's batches.  (The JAX loop draws
        # its next epochs from the first epoch's draws again: fault R4.)
        for _epoch in range(start_epoch):
            epoch_order = rng.permutation(np.repeat(train_idx, aug_factor))
            for _batch in iter_epoch_batches(epoch_order, batch_size, rng=rng):
                pass

    best = {"accuracy": -1.0, "loss": float("inf")}
    best_variables: Optional[dict] = None
    for epoch in range(start_epoch, epochs):
        t0 = time.monotonic()
        epoch_order = rng.permutation(np.repeat(train_idx, aug_factor))
        losses = []
        for batch_idx, weights in iter_epoch_batches(epoch_order, batch_size,
                                                     rng=rng):
            metrics = trainer.run_train_step(
                signals[batch_idx], labels[batch_idx], weights
            )
            losses.append(metrics["loss"])
        train_loss = (float(np.mean(torch.stack(losses).tolist()))
                      if losses else 0.0)
        val = (
            trainer.run_eval(signals[val_idx], labels[val_idx])
            if n_val
            else {"loss": 0.0, "accuracy": 0.0}
        )
        if epoch % log_every == 0 or epoch == epochs - 1:
            log(
                f"  epoch {epoch + 1}/{epochs}: train loss {train_loss:.4f}, "
                f"val loss {val['loss']:.4f}, val acc {val['accuracy']:.3f} "
                f"({time.monotonic() - t0:.1f}s)"
            )
        if checkpoint_dir:
            trainer.save_checkpoint(checkpoint_dir, epoch)
        if val["accuracy"] >= best["accuracy"]:
            best = dict(val)
            # Snapshot the weights that achieved this validation score — the
            # exported model must be the one its metadata describes, not
            # whatever the final epoch drifted to.
            if n_val:
                best_variables = trainer.export_variables()
    if best_variables is None:
        best_variables = trainer.export_variables()
    return best, best_variables


TINY_PRESET = NetworkConfig(
    input_length=256,
    stem_features=8,
    block_features=(8,),
    inception_features=(16,),
    head_features=16,
)


def _dp_ranks(args) -> int:
    """The ranks ``--dp`` asks for on this host (0 = one per card of this
    process; on the CPU, 1); more than the cards present is an error."""
    if args.device == "cpu":
        return max(args.dp, 1)
    cards = len(mesh.process_cards())
    if args.dp > cards:
        quit_with_error(f"--dp {args.dp} exceeds the {cards} card(s) present")
    return args.dp if args.dp > 0 else max(cards, 1)


def _spawn_ranks(args, world: int) -> None:
    """Run ``train`` as ``world`` ranks on this host and wait for them; if
    one fails, the others are stopped and the run fails."""
    import torch.multiprocessing as mp

    log(f"  data-parallel: {world} ranks on this host")
    try:
        dist.spawn_ranks(train_from_args, (args,), world, args.device)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        quit_with_error(f"a data-parallel rank failed: {exc}")


def train_from_args(args) -> None:
    section("Training the barcode classifier")
    rank, world = dist.group_rank_and_size()
    if world == 1:
        ranks = _dp_ranks(args)
        if ranks > 1:
            _spawn_ranks(args, ranks)
            return
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:  # --device cuda without a card
        quit_with_error(str(exc))
    if world > 1:
        if device.type == "cuda":  # this rank's card
            device = torch.device("cuda", mesh.process_cards()[0])
        if args.batch_size % world:
            quit_with_error(f"--batch_size {args.batch_size} does not divide "
                            f"over {world} data-parallel ranks")
    signals, labels = data_io.load_training_set(args.training_data)
    log(f"  {len(labels)} samples of size {signals.shape[1]}")
    network = TINY_PRESET if args.size == "tiny" else NetworkConfig()
    if signals.shape[1] <= network.input_length:
        quit_with_error(
            f"training samples ({signals.shape[1]}) must be longer than the "
            f"network input ({network.input_length})"
        )
    if labels.max() >= NUM_CLASSES or labels.min() < 0:
        quit_with_error("labels out of range")

    cfg = TrainConfig(
        network=network,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        epochs=args.epochs,
        test_fraction=args.test_fraction,
        aug_factor=args.aug_factor,
        seed=args.seed,
    )
    trainer = Trainer(cfg, device, rank=rank, world=world)
    log(f"  device: {trainer.device}"
        + (f" (rank {rank} of {world})" if world > 1 else ""))
    best, best_variables = train_loop(
        trainer, signals, labels,
        epochs=cfg.epochs, batch_size=cfg.batch_size,
        test_fraction=cfg.test_fraction, aug_factor=cfg.aug_factor,
        seed=cfg.seed, checkpoint_dir=args.checkpoint_dir, resume=args.resume,
    )
    if rank == 0:  # every rank holds the same weights; one writer
        save_model(
            args.out, network, best_variables,
            metadata={"best_val": best, "epochs": cfg.epochs},
        )
        log(f"  saved model to {args.out} (best val acc {best['accuracy']:.3f})")
