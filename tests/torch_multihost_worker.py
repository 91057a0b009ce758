"""One rank of tests/test_torch_multihost.py: a process that joins a gloo
group itself (``parallel.mesh.initialize_distributed``), as each host of
a multi-host job would, and runs one mode.

Usage: python torch_multihost_worker.py <rank> <world> <init_method> <out.pt> <mode>

* ``render``: the time-sharded long render of a tiny seeded decoder over
  the job's ranks; rank 0 writes the gathered audio.
* ``sp``: three DP x SP train steps (``parallel.sp``) on a ('data' 2,
  'time' 2) mesh of 4 processes, from ``trainer.init_state(PRNGKey(0))``
  on every process, over :func:`sp_batch`; every rank writes its losses
  and its state checksum.
* ``tp``: the same three steps as DP x TP (``parallel.tp.
  make_tp_train_step``) on a ('data' 2, 'model' 2) mesh of 4 processes.
* ``crash``: one all-reduce, then rank 1 exits (code 17) while rank 0
  waits in a second all-reduce with a short group timeout; rank 0 writes
  what it raised and how long that took.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONF_KW = dict(sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=16, n_noise_filters=17,
               decoder_mlp_units=32, decoder_mlp_layers=1, decoder_gru_units=32,
               reverb_length=512)
FRAMES = 64
# the DP x SP step: two STFT scales whose n_fft//2 + 1 fits a 512-sample
# shard, and the float32 reverb and loss gradients of the single step it
# is held to
SP_KW = dict(CONF_KW, mss_ffts=(256, 128), loss_matmul_dtype="float32",
             reverb_grad_matmul_dtype="float32")
SP_BATCH, SP_FRAMES, SP_STEPS = 4, 16, 3
GROUP_TIMEOUT = 10.0  # seconds a collective waits for a dead peer


def features():
    rng = np.random.default_rng(0)
    return {"f0": rng.uniform(100, 400, (1, FRAMES, 1)).astype(np.float32),
            "normalized_cents": rng.uniform(0, 1, (1, FRAMES, 1)).astype(np.float32),
            "loudness": rng.uniform(0, 1, (1, FRAMES, 1)).astype(np.float32)}


def sp_batch():
    rng = np.random.default_rng(7)
    b, t = SP_BATCH, SP_FRAMES
    return {"f0": rng.uniform(100, 400, (b, t, 1)).astype(np.float32),
            "normalized_cents": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
            "loudness": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
            "audio": (0.1 * rng.standard_normal((b, t * CONF_KW["hop_length"]))).astype(
                np.float32)}


def run_steps(dev, mode):
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel.mesh import make_mesh
    from ddsp_tpu_torch.parallel.sp import make_sp_train_step, shard_sp_batch
    from ddsp_tpu_torch.parallel.tp import make_dp_tp_mesh, make_tp_train_step
    from ddsp_tpu_torch.parallel.train import shard_batch, shard_state, state_checksum
    from ddsp_tpu_torch.training.trainer import init_state

    conf = Config(**SP_KW)
    if mode == "sp":
        mesh = make_mesh(n_data=2, n_time=2)
        step, shard = make_sp_train_step(conf, mesh, device=dev), shard_sp_batch
    else:
        mesh = make_dp_tp_mesh(n_data=2, n_model=2)
        step, shard = make_tp_train_step(conf, mesh, device=dev), shard_batch
    state = shard_state(init_state(PRNGKey(0), conf, device=dev), mesh)
    batch = shard(sp_batch(), mesh, device=dev)
    losses = []
    for _ in range(SP_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "checksum": state_checksum(state).numpy()}


def main(rank: int, world: int, init_method: str, out: str, mode: str) -> None:
    import torch.distributed as dist

    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel.mesh import gather_time, initialize_distributed, make_mesh
    from ddsp_tpu_torch.parallel.render import render_long_audio

    torch.set_num_threads(1)
    dev = initialize_distributed(init_method, world, rank, backend="gloo",
                                 timeout=GROUP_TIMEOUT, device="cpu")
    if mode in ("sp", "tp"):
        torch.save(run_steps(dev, mode), out)
        dist.barrier()
        dist.destroy_process_group()
        return
    if mode == "render":
        conf = Config(**CONF_KW)
        mesh = make_mesh(n_time=world)
        audio = gather_time(render_long_audio(decoder_init(conf, seed=0), features(), conf,
                                              mesh, PRNGKey(7), device=dev), mesh)
        if rank == 0:
            torch.save({"audio": audio.numpy()}, out)
        dist.barrier()
        dist.destroy_process_group()
        return
    x = torch.ones(4)
    dist.all_reduce(x)
    if rank == 1:
        os._exit(17)  # a host dies between two collectives
    t0 = time.monotonic()
    try:
        dist.all_reduce(x)
        torch.save({"survived": float(x[0])}, out)
    except Exception as e:  # the survivor's detection of the dead peer
        torch.save({"detected": f"{type(e).__name__}: {e}", "seconds": time.monotonic() - t0},
                   out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
