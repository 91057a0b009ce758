"""Training entrypoint: ``python -m ddsp_tpu_torch.training.train --data_dir=...``.

Counterpart of ``ddsp_tpu/training/train.py`` (reference
train/train.py:46-55): WAV files -> examples -> frozen-encoder features ->
decoder training, with every Config field settable as ``--key=value``;
then, with ``--finetune_crepe=N`` (and ``--pitch_decode=weighted``), N
analysis-by-synthesis steps that finetune CREPE with the decoder, logged to
``finetune_metrics.jsonl`` and checkpointed under ``checkpoint_dir/finetune``.
With ``--resume=1`` (the default) it carries on from the newest ``step_*``
under ``--checkpoint_dir``: the port's own, or the JAX trainer's Orbax
directory with its whole state (``trainer.restore_checkpoint``).
Runs on CUDA unless ``--device=cpu``.
"""

from __future__ import annotations

import sys

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.data.dataset import extract_features
from ddsp_tpu_torch.device import resolve_device
from ddsp_tpu_torch.models.crepe import crepe_init, load_torch_checkpoint
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.training.trainer import (
    finetune,
    fit,
    init_state,
    latest_checkpoint,
    make_finetune_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)


def main(argv=None):
    """Run the CLI on ``argv``; returns the final ``TrainState``: the
    finetune state's with ``--finetune_crepe``, else the decoder's (None
    for ``--help``)."""
    argv = sys.argv[1:] if argv is None else argv
    extra = {
        "num_steps": 10000,
        "crepe_checkpoint": "",
        "resume": 1,
        # optimizer steps per host read of the metrics (features and
        # minibatch gathers stay on the device); 0/1 = one host batch a step
        "device_steps": 50,
        # fraction of examples held out; their mean MSS loss is logged as
        # eval_loss (reference: limit_val_batches=0.01)
        "eval_split": 0.0,
        # analysis-by-synthesis steps after the feature-based training:
        # decoder and CREPE optimised through the encoder (needs
        # --pitch_decode=weighted); the reference only comments on this
        # (encoder.py:32-34)
        "finetune_crepe": 0,
        "device": "cuda",
    }
    if any(a in ("-h", "--help") for a in argv):
        import dataclasses

        print(__doc__.strip())
        print("\nTrainer flags (defaults):")
        for k, v in extra.items():
            print(f"  --{k}={v!r}")
        print("\nConfig flags (any Config field, defaults):")
        for f in dataclasses.fields(Config):
            print(f"  --{f.name}={f.default!r}")
        return
    flags = []
    for a in argv:
        key = a[2:].split("=", 1)[0]
        if key in extra:
            extra[key] = type(extra[key])(a.split("=", 1)[1])
        else:
            flags.append(a)
    conf = Config.from_flags(flags)
    if extra["finetune_crepe"]:
        # the finetune precondition, checked before the long main run
        make_finetune_step(conf)
    device = resolve_device(extra["device"])

    if extra["crepe_checkpoint"]:
        crepe = load_torch_checkpoint(extra["crepe_checkpoint"], conf.crepe_capacity)
    else:
        crepe = crepe_init(conf.crepe_capacity, seed=1)
        print("WARNING: no --crepe_checkpoint given; using random CREPE weights")

    print(f"Extracting features from {conf.data_dir} on {device} ...")
    features = extract_features(crepe, conf, device=device)
    n = len(features["audio"])
    print(f"{n} examples x {conf.example_length} samples")

    eval_features = None
    if extra["eval_split"] > 0:
        import numpy as np

        perm = np.random.default_rng(conf.seed).permutation(n)
        n_eval = max(1, int(round(n * extra["eval_split"])))
        eval_features = {k: v[perm[:n_eval]] for k, v in features.items()}
        features = {k: v[perm[n_eval:]] for k, v in features.items()}
        print(f"held out {n_eval} examples for eval")

    state = None
    ckpt = latest_checkpoint(conf.checkpoint_dir) if extra["resume"] else None
    if ckpt:
        template = init_state(PRNGKey(conf.seed), conf, device)
        state = restore_checkpoint(ckpt, template)
        print(f"Resumed from {ckpt} at step {int(state.step)}")

    state, metrics = fit(
        conf,
        features,
        num_steps=extra["num_steps"],
        state=state,
        log_path=f"{conf.checkpoint_dir}/metrics.jsonl",
        dump_audio_dir=f"{conf.checkpoint_dir}/audio",
        device_steps=extra["device_steps"],
        eval_features=eval_features,
        device=device,
    )
    print("final:", metrics)

    if extra["finetune_crepe"]:
        print(f"finetuning CREPE for {extra['finetune_crepe']} steps ...")
        state, ft_metrics = finetune(
            conf,
            features["audio"],
            extra["finetune_crepe"],
            state.params,
            crepe,
            log_path=f"{conf.checkpoint_dir}/finetune_metrics.jsonl",
            device=device,
        )
        save_checkpoint(f"{conf.checkpoint_dir}/finetune", state, conf)
        wait_for_checkpoints()  # a failed commit raises before success is declared
        print("finetune final:", ft_metrics)
    return state


if __name__ == "__main__":
    main()
