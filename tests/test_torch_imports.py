"""Import hygiene of the port, and its refusal to fall back to the CPU.

The port must run on a machine with no jax: neither importing any of its
modules nor ``chip_smoke.py`` may load jax or the JAX package, nor orbax,
tensorstore or zstandard, which that machine lacks as well.  Its
serving and training entry points default to CUDA and must raise, not
quietly run on the CPU, when there is no GPU and the caller did not ask
for the CPU.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ddsp_tpu_torch
from ddsp_tpu_torch import reconstruct
from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init
from ddsp_tpu_torch.data import dataset
from ddsp_tpu_torch.experiments import dream, style_transfer
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, make_mesh3
from ddsp_tpu_torch.parallel.render import render_long_audio
from ddsp_tpu_torch.parallel.sp import make_sp_train_step, shard_sp_batch
from ddsp_tpu_torch.parallel.tp import (decoder_apply_tp, make_dp_tp_mesh, make_tp_train_step,
                                        render_controls_tp)
from ddsp_tpu_torch.parallel.train import make_parallel_train_step, shard_batch, shard_state
from ddsp_tpu_torch.runtime import server
from ddsp_tpu_torch.data.audio_io import write_wav
from ddsp_tpu_torch.runtime.jack_io import run_file_loopback
from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
from ddsp_tpu_torch.runtime.streaming import BlockSynthesizer
from ddsp_tpu_torch.runtime.threaded import ThreadedSynthesizer
from ddsp_tpu_torch.training import train, trainer
from ddsp_tpu_torch.utils import multistream_frontier, server_drive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the training slice's modules, which the import walk below must reach
TRAINING_MODULES = (
    "ddsp_tpu_torch.device", "ddsp_tpu_torch.losses",
    "ddsp_tpu_torch.data.dataset", "ddsp_tpu_torch.models.encoder",
    "ddsp_tpu_torch.models.autoencoder", "ddsp_tpu_torch.ops.cuda.build",
    "ddsp_tpu_torch.ops.cuda.osc_frames", "ddsp_tpu_torch.training.trainer",
    "ddsp_tpu_torch.training.train", "ddsp_tpu_torch.utils.profile_training",
    "ddsp_tpu_torch.ops.cuda.stft", "ddsp_tpu_torch.ops.spectral",
    "ddsp_tpu_torch.models.convert",
)
# the oscillator-variant slice's modules
VARIANT_MODULES = (
    "ddsp_tpu_torch.ops.osc_fill", "ddsp_tpu_torch.ops.cuda.osc_cheb",
    "ddsp_tpu_torch.ops.cuda.osc_banked_bwd", "ddsp_tpu_torch.ops.cuda.osc_variants",
    "ddsp_tpu_torch.utils.osc_sweep",
)
# the bf16 reverb backward's modules (S1)
CT_CONV_MODULES = (
    "ddsp_tpu_torch.ops.cuda.ct_conv", "ddsp_tpu_torch.utils.ct_conv_ab",
    "ddsp_tpu_torch.utils.profile_reverb_grad",
)
# the single-stream real-time path's modules
REALTIME_MODULES = (
    "ddsp_tpu_torch.native", "ddsp_tpu_torch.runtime.threaded",
    "ddsp_tpu_torch.runtime.jack_io", "ddsp_tpu_torch.runtime.streaming",
    "ddsp_tpu_torch.ops", "ddsp_tpu_torch.models",
)
# the parallel layer's modules
PARALLEL_MODULES = (
    "ddsp_tpu_torch.parallel", "ddsp_tpu_torch.parallel.mesh",
    "ddsp_tpu_torch.parallel.collectives", "ddsp_tpu_torch.parallel.render",
    "ddsp_tpu_torch.parallel.tp", "ddsp_tpu_torch.parallel.train",
    "ddsp_tpu_torch.parallel.launch", "ddsp_tpu_torch.parallel.sp",
)
# the spectrogram experiments' modules
EXPERIMENT_MODULES = (
    "ddsp_tpu_torch.ops.griffin_lim", "ddsp_tpu_torch.experiments",
    "ddsp_tpu_torch.experiments.lbfgs", "ddsp_tpu_torch.experiments.style_transfer",
    "ddsp_tpu_torch.experiments.dream", "ddsp_tpu_torch.experiments.ui",
    "ddsp_tpu_torch.utils.gl_quality_curve",
)
# the measurement layer's modules
MEASUREMENT_MODULES = (
    "ddsp_tpu_torch.utils.profiling", "ddsp_tpu_torch.utils.roofline",
    "ddsp_tpu_torch.utils.multistream_frontier", "ddsp_tpu_torch.utils.server_drive",
)
# the Orbax checkpoint reader's modules
CHECKPOINT_MODULES = ("ddsp_tpu_torch.models.orbax", "ddsp_tpu_torch.native.zstd")
# the offline reconstruction slice's modules
RECONSTRUCT_MODULES = (
    "ddsp_tpu_torch.reconstruct", "ddsp_tpu_torch.models.lightning_export",
    "ddsp_tpu_torch.models.crepe", "ddsp_tpu_torch.data.audio_io",
)


# what the card's machine lacks: the port reads Orbax checkpoints without them
CHECKPOINT_PACKAGES = ("orbax", "tensorstore", "zstandard")


def _banned(name: str) -> bool:
    return name in ("jax", "optax") or name.startswith(("jax.", "jaxlib", "optax.")) or (
        name == "ddsp_tpu" or name.startswith("ddsp_tpu.")
    ) or name.split(".")[0] in CHECKPOINT_PACKAGES


def test_every_module_imports_without_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import ddsp_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ddsp_tpu_torch.__path__, "ddsp_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        print(",".join(names))
        print(",".join(sorted(m for m in sys.modules
              if m in ("jax", "optax") or m.startswith(("jax.", "jaxlib", "optax."))
              or m == "ddsp_tpu" or m.startswith("ddsp_tpu.")
              or m.split(".")[0] in ("orbax", "tensorstore", "zstandard"))))
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names, loaded = proc.stdout.split("\n")[:2]
    names = names.split(",")
    assert len(names) >= 28
    assert set(TRAINING_MODULES) <= set(names)
    assert set(VARIANT_MODULES) <= set(names)
    assert set(CT_CONV_MODULES) <= set(names)
    assert set(REALTIME_MODULES) <= set(names)
    assert set(RECONSTRUCT_MODULES) <= set(names)
    assert set(PARALLEL_MODULES) <= set(names)
    assert set(EXPERIMENT_MODULES) <= set(names)
    assert set(MEASUREMENT_MODULES) <= set(names)
    assert set(CHECKPOINT_MODULES) <= set(names)
    assert loaded == "", f"port imports pulled in {loaded}"


def test_realtime_imports_build_nothing():
    """Importing the real-time modules and the package exports runs no
    compiler and loads no library: the ring and the kernels build at first
    use."""
    code = textwrap.dedent(
        """
        import subprocess
        def refuse(*a, **k):
            raise AssertionError(f"a build ran at import: {a}")
        subprocess.run = subprocess.Popen = refuse
        import ddsp_tpu_torch.native as native
        import ddsp_tpu_torch.runtime.threaded, ddsp_tpu_torch.runtime.jack_io
        import ddsp_tpu_torch.reconstruct, ddsp_tpu_torch.data.dataset
        from ddsp_tpu_torch.models import oscillator_live
        from ddsp_tpu_torch.ops import upsample_linear
        from ddsp_tpu_torch.ops.cuda import build
        assert native._lib is None and native._corpus_lib is None and not build._libs
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("ddsp_tpu_torch") for n in names)
    assert not [n for n in names if _banned(n)]


def test_package_source_never_names_jax_imports():
    pkg = os.path.dirname(ddsp_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        assert not [a.name for a in node.names if _banned(a.name)], f
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        assert not _banned(node.module), f


CONF = Config(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12,
    n_noise_filters=9, decoder_mlp_units=16, decoder_mlp_layers=1,
    decoder_gru_units=16, reverb_length=300,
)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _features(conf, n=4):
    t = conf.frames_per_example
    return {"f0": np.full((n, t, 1), 200.0, np.float32),
            "normalized_cents": np.full((n, t, 1), 0.4, np.float32),
            "loudness": np.full((n, t, 1), 0.7, np.float32),
            "audio": np.zeros((n, conf.example_length), np.float32)}


@pytest.mark.parametrize("entry", [
    "multistream", "stream_server", "cli", "block_synth", "threaded", "loopback",
    "fit", "init_state", "extract_features", "train_cli",
    "finetune", "init_finetune_state", "finetune_cli", "reconstruct_cli",
    "reconstruct_file", "initialize_distributed", "render_long_audio", "render_controls_tp",
    "make_parallel_train_step", "make_sp_train_step", "make_tp_train_step", "style_transfer_spec",
    "style_transfer_audio",
    "style_transfer_cli", "dream", "dream_file", "dream_cli",
    "frontier_measure", "frontier_cli", "server_drive", "server_drive_cli",
])
def test_entry_points_raise_without_cuda(no_cuda, entry, tmp_path):
    params, crepe = decoder_init(CONF), crepe_init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "multistream":
            MultiStreamServer(params, crepe, CONF, n_streams=2)
        elif entry == "block_synth":
            BlockSynthesizer(params, crepe, CONF)
        elif entry == "threaded":
            ThreadedSynthesizer(params, crepe, CONF)
        elif entry == "loopback":
            write_wav(str(tmp_path / "in.wav"), np.zeros(4 * CONF.hop_length), CONF.sample_rate)
            run_file_loopback(params, crepe, CONF, str(tmp_path / "in.wav"),
                              str(tmp_path / "out.wav"))
        elif entry == "stream_server":
            server.StreamServer(params, crepe, CONF, str(tmp_path / "s.sock"))
        elif entry == "cli":
            server.main(["--lightning_ckpt=missing.ckpt", "--n_streams=2"])
        elif entry == "fit":
            trainer.fit(CONF, _features(CONF), num_steps=1)
        elif entry == "init_state":
            trainer.init_state(PRNGKey(0), CONF)
        elif entry == "extract_features":
            dataset.extract_features(crepe, CONF, examples=_features(CONF)["audio"])
        elif entry == "finetune":
            trainer.finetune(CONF.replace(pitch_decode="weighted"), _features(CONF)["audio"],
                             1, params, crepe)
        elif entry == "init_finetune_state":
            trainer.init_finetune_state(PRNGKey(0), CONF)
        elif entry == "reconstruct_cli":
            reconstruct.main([str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                              "--lightning_ckpt=missing.ckpt"])
        elif entry == "reconstruct_file":
            reconstruct.reconstruct_file(str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                                         CONF, decoder=params)
        elif entry == "initialize_distributed":
            initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0)
        elif entry == "render_long_audio":
            render_long_audio(params, _features(CONF), CONF, None, PRNGKey(0))
        elif entry == "render_controls_tp":
            render_controls_tp(params.reverb, {}, CONF, None, PRNGKey(0))
        elif entry == "make_parallel_train_step":
            make_parallel_train_step(CONF, None)
        elif entry == "make_sp_train_step":
            make_sp_train_step(CONF, None)
        elif entry == "make_tp_train_step":
            make_tp_train_step(CONF, None)
        elif entry == "style_transfer_spec":
            spec = np.zeros((257, 20), np.float32)
            style_transfer.style_transfer_spec(spec, spec, style_transfer.StyleTransferConfig())
        elif entry == "style_transfer_audio":
            audio = np.zeros(8192, np.float32)
            style_transfer.style_transfer_audio(audio, audio)
        elif entry == "style_transfer_cli":
            style_transfer.main([str(tmp_path / n) for n in ("c.wav", "s.wav", "o.wav")])
        elif entry == "dream":
            dream.dream(crepe, np.zeros((1, 2048), np.float32))
        elif entry == "dream_file":
            dream.dream_file(crepe, str(tmp_path / "in.wav"), str(tmp_path / "out.wav"))
        elif entry == "dream_cli":
            dream.main([str(tmp_path / n) for n in ("tiny.pth", "in.wav", "out.wav")])
        elif entry == "frontier_measure":
            multistream_frontier.measure(2, params, crepe, CONF)
        elif entry == "frontier_cli":
            multistream_frontier.main(["--slots=2"])
        elif entry == "server_drive":
            server_drive.drive(params, crepe, CONF, clients=1, slots=1)
        elif entry == "server_drive_cli":
            server_drive.main(["--clients=1"])
        elif entry == "finetune_cli":
            train.main([f"--data_dir={tmp_path}", "--num_steps=1", "--finetune_crepe=1",
                        "--pitch_decode=weighted"])
        else:
            train.main([f"--data_dir={tmp_path}", "--num_steps=1"])


def test_explicit_cpu_runs(no_cuda):
    srv = MultiStreamServer(decoder_init(CONF), crepe_init(), CONF, n_streams=2,
                            device="cpu")
    out = srv.process(torch.zeros(2, CONF.hop_length).numpy())
    assert out.shape == (2, CONF.hop_length)
    conf = CONF.replace(batch_size=2, example_duration=0.2, mss_ffts=(128, 64),
                        checkpoint_every=0)
    state = trainer.init_state(PRNGKey(0), conf, device="cpu")
    assert state.rng.device.type == "cpu"
    state, metrics = trainer.fit(conf, _features(conf), num_steps=1, state=state,
                                 device="cpu")
    assert state.step == 1 and np.isfinite(metrics["loss"])
    conf = conf.replace(pitch_decode="weighted")
    ft = trainer.init_finetune_state(PRNGKey(0), conf, device="cpu")
    assert ft.rng.device.type == "cpu"
    ft, metrics = trainer.finetune(conf, _features(conf)["audio"], 1, ft.params["decoder"],
                                   ft.params["crepe"], device="cpu")
    assert ft.step == 1 and np.isfinite(metrics["loss"])


def test_experiment_entry_points_run_on_explicit_cpu(no_cuda, tmp_path):
    """Style transfer (2 steps at 8 kHz, n_fft 256, 16 features) and the
    dream (1 iteration) run where the CPU is asked for."""
    conf = style_transfer.StyleTransferConfig(n_fft=256, hop=64, n_features=16, n_steps=2,
                                              gl_iters=2, sample_rate=8000)
    rng = np.random.default_rng(0)
    content, style = (rng.standard_normal(2048).astype(np.float32) for _ in range(2))
    out, metrics = style_transfer.style_transfer_audio(content, style, conf, device="cpu")
    assert out.shape == (2048,) and np.isfinite(out).all() and np.isfinite(metrics["loss"])
    write_wav(str(tmp_path / "in.wav"), 0.1 * content, 16000)
    value = dream.dream_file(crepe_init(), str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                             iterations=1, lr=1.0, device="cpu")
    assert np.isfinite(value) and (tmp_path / "out.wav").exists()


def test_parallel_entry_points_run_on_explicit_cpu(no_cuda, tmp_path):
    """A world of one rank on gloo: the parallel entry points run where the
    CPU is asked for, and the backend follows the device."""
    import torch.distributed as dist

    conf = CONF.replace(batch_size=2, example_duration=0.2, mss_ffts=(128, 64))
    try:
        dev = initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
        assert dev.type == "cpu" and dist.get_backend() == "gloo"
        params = decoder_init(conf)
        feats = _features(conf, n=2)
        audio = render_long_audio(params, feats, conf, make_mesh(n_time=1), PRNGKey(0),
                                  device="cpu")
        assert audio.shape == (2, conf.example_length) and torch.isfinite(audio).all()
        controls, _ = params.controller({k: torch.from_numpy(v) for k, v in feats.items()})
        tp_audio = render_controls_tp(params.reverb, controls, conf, make_dp_tp_mesh(1, 1),
                                      PRNGKey(0), device="cpu")
        assert torch.allclose(tp_audio, audio, rtol=0, atol=1e-5)
        decoded = decoder_apply_tp(params, feats, conf, make_dp_tp_mesh(1, 1), PRNGKey(0),
                                   device="cpu")
        assert torch.equal(decoded, tp_audio)
        mesh = make_mesh(n_data=1)
        state = shard_state(trainer.init_state(PRNGKey(0), conf, device="cpu"), mesh)
        step = make_parallel_train_step(conf, mesh, device="cpu")
        state, metrics = step(state, shard_batch(feats, mesh, device="cpu"))
        assert state.step == 1 and torch.isfinite(metrics["loss"])
        mesh = make_mesh(n_data=1, n_time=1)
        step = make_sp_train_step(conf, mesh, device="cpu")
        state, sp_metrics = step(state, shard_sp_batch(feats, mesh, device="cpu"))
        assert state.step == 2 and torch.isfinite(sp_metrics["loss"])
        mesh = make_dp_tp_mesh(1, 1)
        step = make_tp_train_step(conf, mesh, device="cpu")
        state, tp_metrics = step(state, shard_batch(feats, mesh, device="cpu"))
        assert state.step == 3 and torch.isfinite(tp_metrics["loss"])
        mesh = make_mesh3(1, 1, 1)
        step = make_sp_train_step(conf, mesh, device="cpu")
        state, sp3_metrics = step(state, shard_sp_batch(feats, mesh, device="cpu"))
        assert state.step == 4 and torch.isfinite(sp3_metrics["loss"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_distributed_keeps_only_a_group_of_the_asked_backend(tmp_path):
    """An existing group is kept when its backend is the one asked for, and
    asking for another backend raises instead of running on the old one."""
    import torch.distributed as dist

    try:
        dev = initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
        assert initialize_distributed(device="cpu") == dev and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="a gloo process group exists"):
            initialize_distributed(backend="ucc", device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
