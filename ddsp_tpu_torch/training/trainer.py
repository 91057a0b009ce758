"""Training loop: Adam + plateau schedule, checkpoints, metrics.

Counterpart of ``ddsp_tpu/training/trainer.py`` (reference
train/train.py:15-55): decoder-only training against the multi-scale
spectral loss on precomputed features, Adam(1e-3) with a loss-plateau LR
decay, held-out loss, reconstruction dumps, JSONL metrics; and the
analysis-by-synthesis finetune of CREPE with the decoder through the
encoder (``loss_fn_e2e``, ``make_finetune_step``, ``finetune``).

In the port:

* the parameters are an ``nn.Module`` (the decoder, or for finetuning an
  ``nn.ModuleDict`` ``{'decoder', 'crepe'}``) that the optimizer updates
  in place (JAX returns new arrays); ``TrainState`` carries the step, the
  module, the optimizer state (Adam moments and the plateau state, as
  tensors on the device) and the threefry key, split every step as the JAX
  trainer splits it, so the two draw the same noise;
* the loss spectrograms take ``conf.loss_matmul_dtype`` ('bfloat16' ->
  ``torch.bfloat16``, 'float32' -> None), which selects the bf16
  power-STFT kernels under ``ops/spectral.set_stft_impl('pallas')``;
* the optimizer is Adam followed by optax's ``reduce_on_plateau`` state
  machine, written out here (``AdamPlateau``), not torch's
  ``ReduceLROnPlateau``: the loss is averaged over windows of
  ``accumulation_size`` steps and patience counts windows
  (config.py's ``lr_plateau_accumulation``);
* nothing in a step reads a value back to the host, so the
  ``device_steps`` loop queues a window of steps on the card and reads
  its metrics once;
* checkpoints are ``step_%08d/state.pt`` directories written by
  ``torch.save`` into a temporary directory and renamed into place on one
  background thread.  A JAX-package Orbax ``step_*`` directory is read
  too, without tensorstore (``models/orbax.py``): its decoder
  (``load_checkpoint_decoder``) or its whole state (``restore_checkpoint``),
  so training resumes from it where the JAX trainer stopped.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.losses import (
    mss_loss_per_scale,
    mss_loss_per_scale_cached,
    target_mag_key,
    target_spectrograms,
)
from ddsp_tpu_torch.models.autoencoder import autoencoder_apply, autoencoder_init
from ddsp_tpu_torch.models.controller import Decoder, decoder_apply, decoder_init
from ddsp_tpu_torch.models.crepe import make_statistics_trainable
from ddsp_tpu_torch.ops.fir import PRNGKey, fold_in, split
from ddsp_tpu_torch.utils.profiling import backward_span, named_scope

# keys the train step consumes; the rest of the feature dict
# (probabilities, harmonicity) stays on the host
TRAIN_KEYS = ("f0", "normalized_cents", "loudness", "audio")


# --- optimizer -----------------------------------------------------------------
class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: steps taken
    mu: List[torch.Tensor]  # first moments, one per parameter
    nu: List[torch.Tensor]  # second moments


class PlateauState(NamedTuple):
    """optax ``ReduceLROnPlateauState``, field for field."""

    scale: torch.Tensor  # () float32, multiplies Adam's update
    best_value: torch.Tensor  # () float32
    plateau_count: torch.Tensor  # () int32, windows without improvement
    cooldown_count: torch.Tensor  # () int32
    count: torch.Tensor  # () int32, values in the current window
    avg_value: torch.Tensor  # () float32, the window's running mean


class OptState(NamedTuple):
    adam: AdamState
    plateau: PlateauState


class AdamPlateau:
    """``optax.chain(optax.adam(lr), optax.contrib.reduce_on_plateau(...))``.

    Adam as ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias
    correction by the step count) scaled by ``-lr``; then the plateau scale
    of the state *after* this step's loss is folded in (optax's order), and
    the update is added to the parameters in place.
    """

    def __init__(self, learning_rate: float, *, factor: float, patience: int,
                 rtol: float = 1e-4, atol: float = 0.0, cooldown: int = 0,
                 accumulation_size: int = 1, min_scale: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
        if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) or rtol > 1.0:
            raise ValueError(f"need 0 <= rtol <= 1, atol >= 0, one positive; got {rtol}, {atol}")
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size = cooldown, accumulation_size
        self.min_scale = min_scale

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return OptState(
            AdamState(
                torch.zeros((), **i32),
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params],
            ),
            PlateauState(
                scale=torch.ones((), **f32),
                best_value=torch.full((), float("inf"), **f32),
                plateau_count=torch.zeros((), **i32),
                cooldown_count=torch.zeros((), **i32),
                count=torch.zeros((), **i32),
                avg_value=torch.zeros((), **f32),
            ),
        )

    def plateau_update(self, st: PlateauState, value: torch.Tensor) -> PlateauState:
        """optax ``reduce_on_plateau``'s ``update_fn`` on the state alone,
        with ``lax.cond`` branches as ``torch.where`` selects."""
        new_count = st.count + 1
        avg = (st.count * st.avg_value + value.to(st.avg_value.dtype)) / new_count
        improved = avg < (1 - self.rtol) * st.best_value - self.atol
        best = torch.where(improved, avg, st.best_value)
        plateau = torch.where(improved, 0, st.plateau_count + 1).to(torch.int32)
        hit = plateau == self.patience
        cooling = st.cooldown_count > 0
        scale = torch.where(
            cooling, st.scale,
            torch.clamp(torch.where(hit, st.scale * self.factor, st.scale), min=self.min_scale),
        )
        plateau = torch.where(cooling | hit, 0, plateau).to(torch.int32)
        zero_i, zero_f = torch.zeros_like(st.count), torch.zeros_like(st.avg_value)
        cooldown = torch.where(
            cooling, st.cooldown_count - 1,
            torch.where(hit, torch.full_like(zero_i, self.cooldown), zero_i),
        ).to(torch.int32)
        full = new_count == self.accumulation_size
        return PlateauState(
            scale=torch.where(full, scale, st.scale),
            best_value=torch.where(full, best, st.best_value),
            plateau_count=torch.where(full, plateau, st.plateau_count),
            cooldown_count=torch.where(full, cooldown, st.cooldown_count),
            count=torch.where(full, zero_i, new_count.to(torch.int32)),
            avg_value=torch.where(full, zero_f, avg),
        )

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: OptState, value: torch.Tensor) -> OptState:
        """Update ``params`` in place from ``grads`` and the step's loss
        ``value``; returns the new state (the old one's moment tensors are
        updated in place too).  Each operation runs over every tensor at
        once (``torch._foreach_*``, a few launches each on the card) with the
        arithmetic of a loop over the tensors, whose ten launches a tensor
        took the host longer to issue than the card to run."""
        adam = state.adam
        count = adam.count + 1
        bc1 = 1 - self.b1 ** count.float()
        bc2 = 1 - self.b2 ** count.float()
        plateau = self.plateau_update(state.plateau, value)
        step_size = -self.lr * plateau.scale
        torch._foreach_mul_(adam.mu, self.b1)
        torch._foreach_add_(adam.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(adam.nu, self.b2)
        torch._foreach_addcmul_(adam.nu, grads, grads, value=1 - self.b2)
        update = torch._foreach_div(adam.mu, bc1)
        denom = torch._foreach_div(adam.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, step_size)
        torch._foreach_add_(params, update)
        return OptState(AdamState(count, adam.mu, adam.nu), plateau)


def make_optimizer(conf: Config) -> AdamPlateau:
    """Adam + loss-plateau LR decay (``trainer.py:46-63`` of the JAX
    package): patience counts windows of ``conf.lr_plateau_accumulation``
    steps (1 = the reference's per-step monitoring)."""
    return AdamPlateau(
        conf.learning_rate,
        factor=conf.lr_plateau_factor,
        patience=conf.lr_plateau_patience,
        accumulation_size=max(1, conf.lr_plateau_accumulation),
    )


# --- state, loss, steps ----------------------------------------------------------
class TrainState(NamedTuple):
    step: int
    params: nn.Module  # the Decoder, or {'decoder', 'crepe'} when finetuning
    opt_state: OptState
    rng: torch.Tensor  # (2,) int64 threefry key (uint32 words)


def init_state(key: torch.Tensor, conf: Config, device="cuda") -> TrainState:
    """A fresh state from a (2,) threefry key: ``kp, kr = split(key)``; the
    decoder's torch init is seeded from ``kp`` (it cannot reproduce the JAX
    package's init; tests carry weights over with ``decoder_from_jax``)."""
    dev = resolve_device(device)
    kp, kr = split(key.cpu())
    params = decoder_init(conf, seed=int(kp[1])).to(dev)
    opt_state = make_optimizer(conf).init(list(params.parameters()))
    return TrainState(0, params, opt_state, kr.to(dev))


def loss_matmul_dtype(conf: Config) -> Optional[torch.dtype]:
    """``conf.loss_matmul_dtype`` as the losses take it: None for
    'float32', else the torch dtype of that name (``trainer.py:89-93``)."""
    if conf.loss_matmul_dtype == "float32":
        return None
    return getattr(torch, conf.loss_matmul_dtype)


def loss_fn(
    params: nn.Module,
    batch: Dict[str, torch.Tensor],
    conf: Config,
    noise_key: torch.Tensor,
    decode=decoder_apply,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSS reconstruction loss of the decoded controls vs the target audio.

    ``decode`` swaps the decode implementation while keeping the loss
    composition single-sourced.  If the batch carries precomputed target
    spectrograms (``losses.target_spectrograms`` keys), the target-side
    STFTs are skipped.
    """
    pred = decode(params, batch, conf, noise_key)
    dtype = loss_matmul_dtype(conf)
    with named_scope("loss"):
        if target_mag_key(conf.mss_ffts[0]) in batch:
            scales = mss_loss_per_scale_cached(
                pred, batch, conf.mss_ffts, conf.mss_alpha, conf.mss_overlap,
                matmul_dtype=dtype,
            )
        else:
            scales = mss_loss_per_scale(
                pred, batch["audio"], conf.mss_ffts, conf.mss_alpha, conf.mss_overlap,
                matmul_dtype=dtype,
            )
        loss = sum(scales.values())
        backward_span("loss", loss)
    return loss, scales


def make_train_step(conf: Config, loss=None, reduce=None):
    """(state, batch) -> (state, metrics): one optimizer step.

    ``loss`` defaults to :func:`loss_fn`; the finetune step passes
    :func:`loss_fn_e2e` and reuses this optimizer and metrics plumbing.
    ``reduce``, if given, maps (loss, per-scale terms, gradients) to the
    values the optimizer and the metrics take: the data-parallel step's
    all-reduce (``parallel/train.py``).  ``metrics`` holds ``loss``, the
    per-scale ``mss_*`` terms and ``grad_norm``, as device tensors.  The
    parameters are updated in place; the returned state carries step + 1
    and the advanced key.
    """
    opt = make_optimizer(conf)
    loss = loss_fn if loss is None else loss

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with named_scope("train_step"):
            rng, noise_key = split(state.rng)
            params = list(state.params.parameters())
            loss_val, scales = loss(state.params, batch, conf, noise_key)
            with named_scope("backward"):
                grads = torch.autograd.grad(loss_val, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            if reduce is not None:
                with named_scope("all_reduce"):
                    loss_val, scales, grads = reduce(loss_val.detach(), scales, grads)
            with named_scope("optimizer"):
                opt_state = opt.step(params, grads, state.opt_state, loss_val.detach())
                metrics = {k: v.detach() for k, v in scales.items()}
                metrics["loss"] = loss_val.detach()
                metrics["grad_norm"] = torch.sqrt(sum((g * g).sum() for g in grads))
            return TrainState(state.step + 1, state.params, opt_state, rng), metrics

    return train_step


def loss_fn_e2e(
    params: nn.Module,
    batch: Dict[str, torch.Tensor],
    conf: Config,
    noise_key: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Analysis-by-synthesis loss: audio -> encoder (CREPE differentiable)
    -> decoder -> MSS vs the same audio.  ``params`` is ``{'decoder',
    'crepe'}``; ``batch`` needs only 'audio'."""
    pred = autoencoder_apply(params, batch["audio"], conf, noise_key, freeze_crepe=False)
    with named_scope("loss"):
        scales = mss_loss_per_scale(
            pred, batch["audio"], conf.mss_ffts, conf.mss_alpha, conf.mss_overlap,
            matmul_dtype=loss_matmul_dtype(conf),
        )
        loss = sum(scales.values())
        backward_span("loss", loss)
    return loss, scales


def _finetune_state(params: nn.ModuleDict, conf: Config, rng: torch.Tensor,
                    device: torch.device) -> TrainState:
    make_statistics_trainable(params["crepe"])
    params = params.to(device)
    return TrainState(0, params, make_optimizer(conf).init(list(params.parameters())),
                      rng.to(device))


def init_finetune_state(
    key: torch.Tensor, conf: Config, crepe_checkpoint: Optional[str] = None,
    device="cuda",
) -> TrainState:
    """A fresh finetune state over ``{'decoder', 'crepe'}`` from a (2,)
    threefry key (``kp, kr = split(key)``, as the JAX package).

    CREPE's BatchNorm ``running_mean`` / ``running_var`` become optimised
    parameters (``models/crepe.py:make_statistics_trainable``): the JAX
    package keeps them in its parameter tree, so its finetune step takes
    their gradients, moves them with Adam and counts them in
    ``grad_norm``.  ``num_batches_tracked`` stays out, as there.
    """
    dev = resolve_device(device)
    kp, kr = split(key.cpu())
    return _finetune_state(autoencoder_init(kp, conf, crepe_checkpoint), conf, kr, dev)


def make_finetune_step(conf: Config):
    """Analysis-by-synthesis train step: CREPE finetunes with the decoder.

    Needs a differentiable pitch decode: 'argmax' emits hard bins (zero
    gradient into CREPE), so ``conf.pitch_decode`` must be 'weighted' or
    'centered_ref'.  The step's state is a finetune state
    (:func:`init_finetune_state`), BatchNorm statistics among its leaves.
    """
    if conf.pitch_decode == "argmax":
        raise ValueError(
            "analysis-by-synthesis finetuning needs a differentiable pitch "
            "decode: set pitch_decode='weighted' (or 'centered_ref'); "
            "'argmax' passes zero gradient into CREPE"
        )
    return make_train_step(conf, loss=loss_fn_e2e)


def finetune(
    conf: Config,
    audio: np.ndarray,
    num_steps: int,
    decoder_params: nn.Module,
    crepe_params: nn.Module,
    log_path: Optional[str] = None,
    seed: Optional[int] = None,
    device="cuda",
) -> Tuple[TrainState, Dict[str, float]]:
    """Analysis-by-synthesis finetune loop over raw (N, L) audio examples.

    Starts from copies of the trained decoder and the CREPE weights (the
    caller's modules are not changed, as JAX's arrays are not) and
    optimises both through the encoder, BatchNorm statistics included
    (:func:`init_finetune_state`).  Logs every ``conf.log_every`` steps
    and at the last.  Returns the final state (``state.params['crepe']``
    holds the finetuned CREPE) and the last logged metrics.
    """
    from ddsp_tpu_torch.data.dataset import batch_iterator

    dev = resolve_device(device)
    if len(audio) < conf.batch_size:
        raise ValueError(
            f"{len(audio)} examples make no full batch of {conf.batch_size}")
    step_fn = make_finetune_step(conf)
    seed = conf.seed if seed is None else seed
    key, kr = split(PRNGKey(seed))
    params = nn.ModuleDict({"decoder": copy.deepcopy(decoder_params),
                            "crepe": copy.deepcopy(crepe_params)})
    state = _finetune_state(params, conf, kr, dev)
    order = torch.Generator().manual_seed(seed)
    logger = MetricsLogger(log_path)
    last: Dict[str, float] = {}
    steps_done = 0
    t0 = time.time()
    while steps_done < num_steps:
        key, _ = split(key)
        for batch in batch_iterator({"audio": audio}, conf.batch_size, order, device=dev):
            state, metrics = step_fn(state, batch)
            steps_done += 1
            if steps_done % conf.log_every == 0 or steps_done == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                last["steps_per_s"] = steps_done / (time.time() - t0)
                logger.log(int(state.step), last)
            if steps_done >= num_steps:
                break
    logger.close()
    return state, last


def make_eval_step(conf: Config):
    """(params, batch, key) -> scalar MSS loss, no gradient, no optimizer
    (the reference's ``validation_step`` as a loss)."""

    @torch.no_grad()
    def eval_step(params, batch, noise_key):
        return loss_fn(params, batch, conf, noise_key)[0]

    return eval_step


def _held_out_loss(eval_step, params, eval_data, batch_size, key) -> float:
    """Mean eval loss over full batches (rows tiled up if fewer than one)."""
    device = key.device
    n = len(next(iter(eval_data.values())))
    if n < batch_size:  # keep full batches: tile rows up to one
        reps = -(-batch_size // n)
        eval_data = {
            k: np.concatenate([np.asarray(v)] * reps)[:batch_size]
            for k, v in eval_data.items()
        }
        n = batch_size
    total, count = 0.0, 0
    for start in range(0, n - batch_size + 1, batch_size):
        batch = {
            k: torch.from_numpy(np.asarray(v)[start : start + batch_size]).to(device)
            for k, v in eval_data.items()
        }
        total += float(eval_step(params, batch, fold_in(key, start)))
        count += 1
    return total / count


# --- checkpointing -----------------------------------------------------------
# One background thread commits checkpoints, in the order they were issued.
_COMMIT_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []


def _commit_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _COMMIT_POOL
    if _COMMIT_POOL is None:
        _COMMIT_POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint"
        )
    return _COMMIT_POOL


def wait_for_checkpoints() -> None:
    """Block until every issued checkpoint has committed; re-raise the
    first commit error."""
    while _PENDING:
        _PENDING.pop(0).result()


def _prune_checkpoints(ckpt_dir: str, keep: int, protect: str = "") -> None:
    """Delete the oldest ``step_N`` dirs, keeping the newest ``keep``.

    Only exact ``step_N`` names are touched, so a temporary directory of a
    save in flight is never pruned.  ``protect`` names a checkpoint that
    counts toward the budget but is never deleted.
    """
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return
    protect = os.path.basename(protect) if protect else ""
    steps = sorted(
        (d for d in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d+", d) and d != protect),
        key=lambda d: int(d.split("_")[1]),
    )
    if protect:
        keep -= 1  # the protected save occupies one retention slot
    for d in steps[: max(0, len(steps) - keep)]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (list, tuple)):
        return [_to_cpu(v) for v in x]
    return x


def _payload(state: TrainState) -> Dict[str, Any]:
    """The state as plain dicts of CPU tensors (what ``torch.save``
    writes and ``torch.load(weights_only=True)`` reads back)."""
    adam, plateau = state.opt_state
    return {
        "params": {k: _to_cpu(v) for k, v in state.params.state_dict().items()},
        "opt_state": {
            "adam": {"count": _to_cpu(adam.count), "mu": _to_cpu(adam.mu),
                     "nu": _to_cpu(adam.nu)},
            "plateau": {k: _to_cpu(v) for k, v in plateau._asdict().items()},
        },
        "step": int(state.step),
        "rng": _to_cpu(state.rng),
    }


def _commit(path: str, payload: Dict[str, Any], ckpt_dir: str, keep: int) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, "state.pt"))
    if os.path.exists(path):  # a re-saved step overwrites
        shutil.rmtree(path)
    os.replace(tmp, path)
    if keep:
        _prune_checkpoints(ckpt_dir, keep, protect=path)


def save_checkpoint(
    ckpt_dir: str, state: TrainState, conf: Config, block: Optional[bool] = None
) -> str:
    """Checkpoint ``ckpt_dir/step_<N>/`` holding the full state.

    The state is copied to the host here; by default
    (``conf.checkpoint_async``) the write, the atomic rename and the
    pruning to ``conf.checkpoint_keep`` commit on a background thread, and
    ``block=True`` waits for them.  A re-save of an existing step
    overwrites it.  Call :func:`wait_for_checkpoints` before exit or
    restore.
    """
    if block is None:
        block = not conf.checkpoint_async
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{int(state.step):08d}"))
    payload = _payload(state)
    wait_for_checkpoints()  # the previous commit, issued long ago
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        f.write(conf.to_json())
    _PENDING.append(_commit_pool().submit(
        _commit, path, payload, os.path.abspath(ckpt_dir), conf.checkpoint_keep
    ))
    if block:
        wait_for_checkpoints()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest finalised checkpoint, or None.  Only exact ``step_N`` names
    count: a temporary directory left by a killed save is skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d+", d)]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=lambda d: int(d.split("_")[1])))


def _jax_checkpoint(path: str) -> bool:
    """Whether ``path`` is the JAX package trainer's Orbax directory (and
    not the port's own, which holds ``state.pt``)."""
    from ddsp_tpu_torch.models.orbax import is_orbax_checkpoint

    return not os.path.exists(os.path.join(path, "state.pt")) and is_orbax_checkpoint(path)


def load_checkpoint_payload(path: str) -> Dict[str, Any]:
    """The saved state of a ``step_*`` directory on the CPU: the port's
    ``state.pt`` as tensors, or the JAX package trainer's Orbax directory
    as its numpy tree in the JAX layout (``models/orbax.read_orbax``:
    ``{'params', 'opt_state', 'step', 'rng'}``)."""
    from ddsp_tpu_torch.models.orbax import read_orbax

    wait_for_checkpoints()  # same-process restore after an async save
    if _jax_checkpoint(path):
        return read_orbax(path)
    state_file = os.path.join(path, "state.pt")
    if not os.path.exists(state_file):
        raise FileNotFoundError(
            f"{path} holds no state.pt and no Orbax _METADATA / manifest.ocdbt: not "
            "a checkpoint of ddsp_tpu_torch or of the JAX package")
    return torch.load(state_file, map_location="cpu", weights_only=True)


def load_checkpoint_decoder(path: str, conf: Config) -> Decoder:
    """The decoder of a ``step_*`` checkpoint directory: the port's own
    (``state.pt``) or the JAX package's Orbax directory
    (``models/convert.decoder_from_orbax``, which reads the parameters
    alone).  A finetune checkpoint gives its decoder.  Anything else
    raises."""
    from ddsp_tpu_torch.models.convert import decoder_from_orbax

    if _jax_checkpoint(path):
        return decoder_from_orbax(path, conf)
    params = load_checkpoint_payload(path)["params"]
    if any(k.startswith("decoder.") for k in params):
        params = {k[len("decoder."):]: v for k, v in params.items() if k.startswith("decoder.")}
    decoder = Decoder(conf)
    decoder.load_state_dict(params)
    return decoder.eval()


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template``'s parameters (in place) and
    rebuild the optimizer state on its device: the port's own, or the JAX
    package trainer's Orbax directory, whose whole state (parameters,
    optax's Adam moments and count, the plateau state, step and threefry
    key) carries over through ``models/convert.train_state_from_jax``.  A
    finetune checkpoint needs a finetune template
    (:func:`init_finetune_state`)."""
    from ddsp_tpu_torch.models.convert import train_state_from_jax

    payload = load_checkpoint_payload(path)
    if _jax_checkpoint(path):
        return train_state_from_jax(payload, template)
    device = template.rng.device
    template.params.load_state_dict(payload["params"])
    adam, plateau = payload["opt_state"]["adam"], payload["opt_state"]["plateau"]
    opt_state = OptState(
        AdamState(adam["count"].to(device), [m.to(device) for m in adam["mu"]],
                  [v.to(device) for v in adam["nu"]]),
        PlateauState(**{k: v.to(device) for k, v in plateau.items()}),
    )
    return TrainState(payload["step"], template.params, opt_state,
                      payload["rng"].to(device))


# --- metrics -----------------------------------------------------------------
class MetricsLogger:
    """JSONL metrics stream: one row per call, appended and flushed."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


# --- fit loop ----------------------------------------------------------------
def fit(
    conf: Config,
    features: Dict[str, np.ndarray],
    num_steps: int,
    state: Optional[TrainState] = None,
    log_path: Optional[str] = None,
    dump_audio_dir: Optional[str] = None,
    dump_every: int = 10,
    seed: Optional[int] = None,
    device_steps: int = 0,
    eval_features: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
) -> Tuple[TrainState, Dict[str, float]]:
    """Train the decoder on extracted features for ``num_steps`` steps.

    ``device_steps > 1``: the features are uploaded once, each minibatch is
    gathered on the device, target spectrograms are cached there when they
    fit, and the host reads metrics once per window of ``device_steps``
    steps (logging ``loss_mean`` over the window).  Otherwise one host
    batch per step, logging every ``conf.log_every`` steps.

    ``eval_features``: held-out rows whose mean loss is logged as
    ``eval_loss`` at every logging point.
    """
    from ddsp_tpu_torch.data.dataset import batch_iterator

    dev = resolve_device(device)
    seed = conf.seed if seed is None else seed
    key = PRNGKey(seed)
    if state is None:
        key, ks = split(key)
        state = init_state(ks, conf, dev)
    logger = MetricsLogger(log_path)
    eval_step = make_eval_step(conf) if eval_features is not None else None
    eval_data = (
        {k: eval_features[k] for k in TRAIN_KEYS if k in eval_features}
        if eval_features is not None else None
    )
    if device_steps > 1:
        return _fit_device_steps(
            conf, features, num_steps, state, key, seed, logger,
            dump_audio_dir, dump_every, device_steps, eval_step, eval_data, dev,
        )

    step_fn = make_train_step(conf)
    train_features = {k: features[k] for k in TRAIN_KEYS if k in features}
    order = torch.Generator().manual_seed(seed)
    last: Dict[str, float] = {}
    steps_done = 0
    epoch = 0
    t0 = time.time()
    while steps_done < num_steps:
        key, _ = split(key)
        for batch in batch_iterator(train_features, conf.batch_size, order, device=dev):
            state, metrics = step_fn(state, batch)
            steps_done += 1
            if steps_done % conf.log_every == 0 or steps_done == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                last["steps_per_s"] = steps_done / (time.time() - t0)
                if eval_step is not None:
                    last["eval_loss"] = _held_out_loss(
                        eval_step, state.params, eval_data, conf.batch_size,
                        key.to(dev),
                    )
                logger.log(int(state.step), last)
            if conf.checkpoint_every and steps_done % conf.checkpoint_every == 0:
                save_checkpoint(conf.checkpoint_dir, state, conf)
            if steps_done >= num_steps:
                break
        epoch += 1
        if dump_audio_dir and (epoch % dump_every == 0 or steps_done >= num_steps):
            _dump_reconstructions(state, conf, features, dump_audio_dir, epoch)
    logger.close()
    wait_for_checkpoints()
    return state, last


_SPECTRA_CACHE_BYTES = 2 << 30  # cache target spectrograms up to 2 GB


@torch.no_grad()
def _maybe_cache_target_spectra(conf: Config, audio: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-example target spectrograms on ``audio``'s device when they fit
    in 2 GB (they save the target-side STFTs every step); else {}."""
    n, length = audio.shape
    bins = 0
    for nf in conf.mss_ffts:
        hop = int(nf * (1 - conf.mss_overlap))
        frames = (length + 2 * (nf // 2) - nf) // hop + 1
        bins += frames * (nf // 2 + 1)
    if n * bins * 4 > _SPECTRA_CACHE_BYTES:
        return {}
    bs = max(1, conf.batch_size)
    dtype = loss_matmul_dtype(conf)
    outs: Dict[str, list] = {}
    for s in range(0, n, bs):
        for k, v in target_spectrograms(audio[s : s + bs], conf.mss_ffts,
                                        conf.mss_overlap, dtype).items():
            outs.setdefault(k, []).append(v)
    return {k: torch.cat(v, dim=0) for k, v in outs.items()}


def _fit_device_steps(
    conf, features, num_steps, state, key, seed, logger,
    dump_audio_dir, dump_every, device_steps, eval_step, eval_data, dev,
) -> Tuple[TrainState, Dict[str, float]]:
    data = {k: torch.as_tensor(features[k], device=dev) for k in TRAIN_KEYS if k in features}
    spectra = _maybe_cache_target_spectra(conf, data["audio"])
    if spectra:
        data.update(spectra)
        if not conf.z_dims:  # the cached loss never reads the raw audio; a z encoder does
            del data["audio"]
    n = next(iter(data.values())).shape[0]
    order = torch.Generator(device=dev).manual_seed(seed)
    step_fn = make_train_step(conf)
    last: Dict[str, float] = {}
    steps_done = 0
    calls = 0
    next_ckpt = conf.checkpoint_every or float("inf")
    t0 = time.time()
    while steps_done < num_steps:
        chunk = min(device_steps, num_steps - steps_done)
        key, _ = split(key)
        losses = []
        for _ in range(chunk):  # no host read inside the window
            idx = torch.randperm(n, generator=order, device=dev)[: conf.batch_size]
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
        steps_done += chunk
        calls += 1
        last = {k: float(v) for k, v in metrics.items()}
        last["loss_mean"] = float(torch.stack(losses).mean())
        last["steps_per_s"] = steps_done / (time.time() - t0)
        if eval_step is not None:
            last["eval_loss"] = _held_out_loss(
                eval_step, state.params, eval_data, conf.batch_size, key.to(dev)
            )
        logger.log(int(state.step), last)
        if steps_done >= next_ckpt:
            save_checkpoint(conf.checkpoint_dir, state, conf)
            next_ckpt += conf.checkpoint_every
        if dump_audio_dir and (calls % dump_every == 0 or steps_done >= num_steps):
            _dump_reconstructions(state, conf, features, dump_audio_dir, calls)
    logger.close()
    wait_for_checkpoints()
    return state, last


@torch.no_grad()
def _dump_reconstructions(state, conf, features, out_dir, epoch, n=2):
    """Write the first ``n`` examples' reconstructions as wavs (the
    reference's audible validation, train/train.py:39-43): one decoder
    forward."""
    from ddsp_tpu_torch.data.audio_io import write_wav

    os.makedirs(out_dir, exist_ok=True)
    device = state.rng.device
    batch = {
        k: torch.as_tensor(np.asarray(features[k][:n]), device=device)
        for k in ("f0", "normalized_cents", "loudness") + (("audio",) if conf.z_dims else ())
    }
    pred = decoder_apply(state.params, batch, conf, PRNGKey(epoch, device))
    for i, row in enumerate(pred.cpu().numpy()):
        write_wav(
            os.path.join(out_dir, f"epoch{epoch:03d}-{i}.wav"),
            row / max(1e-6, np.abs(row).max()),
            conf.sample_rate,
        )
