"""Real multi-process runs of the port's parallel layer: the counterparts
of tests/test_multihost.py:208 and :221, plus one card test.

Each process joins a gloo group itself through a ``file://`` store
(tests/torch_multihost_worker.py), as each host of a multi-host job would;
every subprocess has a hard timeout, so no test can hang the suite.

* two processes render time-sharded (``render_long_audio``, 2 x 32
  frames) and agree with the single-process decode at > 70 dB, the JAX
  suite's floor (measured 131.2 dB);
* four processes take three DP x SP steps (``parallel.sp``) on a ('data'
  2, 'time' 2) mesh (the counterpart of tests/test_multihost.py:99), and
  three DP x TP steps (``parallel.tp.make_tp_train_step``) on a ('data'
  2, 'model' 2) mesh (the counterpart of tests/test_multihost.py:169):
  every process's losses equal and its state checksum bit-equal, and the
  losses those of the single-process step within 1e-5 relative (SP:
  measured 7.2e-8 at the first step, 0 at the next two; TP: 0, 8.1e-8
  and 1.8e-7);
* one rank exits between two all-reduces: the survivor raises instead of
  hanging, within its 10 s group timeout (measured 0.016 s: gloo sees the
  dead peer's connection reset);
* on a card (marked ``cuda``): the harmonic-sharded render on 4 gloo ranks
  sharing ``cuda:0`` (``chip_smoke.py`` phase 17's case 3 at a small
  width), each rank launching K1 once on the rotation fill at its own
  ``h_start``, against the unsharded card render at > 70 dB; and three
  DP x SP steps on a ('data' 2, 'time' 4) mesh of 8 gloo ranks sharing
  ``cuda:0`` (the CPU suite's (2, 4) case), each rank launching K1 and K2
  once a step on the rotation fill, held to the card's single step at
  ``chip_smoke.py`` phase 9's criterion: loss within 1e-4 and
  ``grad_norm`` within 1e-3 relative, each gradient leaf from the same
  state within 5e-3 of its norm plus 1e-6 of the whole gradient's, the
  parameters after each free-running step at allclose(rtol=2e-3,
  atol=2e-5) (the JAX suite's SP criterion).
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")
PROCESS_TIMEOUT = 120  # seconds for each worker process, start-up included


def _snr(want, got) -> float:
    want = np.asarray(want, np.float64)
    noise = np.mean((want - np.asarray(got, np.float64)) ** 2)
    return float("inf") if noise == 0 else float(10 * np.log10(np.mean(want**2) / noise))


def _launch(mode, tmp_path, world=2):
    """[(exit code, its output file's contents or None, its log)] per rank."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    init = f"file://{tmp_path / f'store_{mode}'}"
    outs = [tmp_path / f"rank{r}_{mode}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), init, str(outs[r]), mode],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    results = []
    try:
        for p, out in zip(procs, outs):
            log, _ = p.communicate(timeout=PROCESS_TIMEOUT)
            data = torch.load(out, weights_only=False) if out.exists() else None
            results.append((p.returncode, data, log.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def test_two_process_time_sharded_render(tmp_path):
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_multihost_worker as worker
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_apply, decoder_init
    from ddsp_tpu_torch.ops.fir import PRNGKey

    results = _launch("render", tmp_path)
    for rc, _, log in results:
        assert rc == 0, log[-3000:]
    conf = Config(**worker.CONF_KW)
    with torch.no_grad():
        want = decoder_apply(decoder_init(conf, seed=0),
                             {k: torch.from_numpy(v) for k, v in worker.features().items()},
                             conf, PRNGKey(7)).numpy()
    got = results[0][1]["audio"]
    assert got.shape == want.shape
    assert _snr(want, got) > 70.0, _snr(want, got)


def _four_process_steps_match_single_process(mode, tmp_path):
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_multihost_worker as worker
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.training.trainer import init_state, make_train_step

    results = _launch(mode, tmp_path, world=4)
    for rc, _, log in results:
        assert rc == 0, log[-3000:]
    got = [d for _, d, _ in results]
    for d in got[1:]:
        assert d["losses"] == got[0]["losses"]
        np.testing.assert_array_equal(d["checksum"], got[0]["checksum"])
    conf = Config(**worker.SP_KW)
    state, step = init_state(PRNGKey(0), conf, device="cpu"), make_train_step(conf)
    batch = {k: torch.from_numpy(v) for k, v in worker.sp_batch().items()}
    for i, loss in enumerate(got[0]["losses"]):
        state, metrics = step(state, batch)
        want = float(metrics["loss"])
        assert abs(loss - want) <= 1e-5 * abs(want), (i, loss, want)


def test_four_process_sp_steps_match_single_process(tmp_path):
    _four_process_steps_match_single_process("sp", tmp_path)


def test_four_process_tp_steps_match_single_process(tmp_path):
    _four_process_steps_match_single_process("tp", tmp_path)


def test_killed_rank_fails_its_survivor(tmp_path):
    (rc0, d0, log0), (rc1, _, _) = _launch("crash", tmp_path)
    assert rc1 == 17  # the scripted death happened
    assert rc0 == 0 and d0 is not None, log0[-3000:]
    assert "detected" in d0, d0  # the survivor raised, it did not complete
    assert d0["seconds"] < 30.0, d0


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tp_render_on_card_launches_k1_per_rank(cuda_device):
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_parallel_cases as cases
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.parallel.launch import run_ranks

    conf_kw = dict(sample_rate=16000, hop_length=128, n_harmonics=40, n_noise_filters=17,
                   reverb_length=2048)
    rng = np.random.default_rng(3)
    b, t = 4, 24
    controls = {"f0": rng.uniform(80, 400, (b, t, 1)).astype(np.float32),
                "c": rng.uniform(0.01, 1, (b, t, 40)).astype(np.float32),
                "a": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
                "H": rng.uniform(0, 1, (b, t, 17)).astype(np.float32)}
    reverb = {"noise": rng.uniform(-1, 1, 2048).astype(np.float32),
              "decay": np.float32(3.0), "wet": np.float32(-2.0)}
    case = dict(kind="tp", conf=conf_kw, ranks=4, controls=controls, reverb=reverb, key=3)
    results = run_ranks(cases.on_card, 4, (case,), backend="gloo", device="cuda", timeout=300,
                        group_timeout=60)
    conf = Config(**conf_kw)
    want = cases.unsharded_render(case, conf, cuda_device)
    for rank, r in enumerate(results):
        assert r["counts"]["osc_frames_fwd"] == 1, r["counts"]
        assert r["h_starts"] == [10 * rank] and r["fills"] == ["rot"], r
        assert _snr(want, r["out"]) > 70.0, (rank, _snr(want, r["out"]))


@pytest.mark.cuda
def test_sp_steps_on_card_launch_k1_k2_per_rank(cuda_device):
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_multihost_worker as worker
    import torch_parallel_cases as cases
    from ddsp_tpu_torch.config import Config
    from ddsp_tpu_torch.models.controller import decoder_init
    from ddsp_tpu_torch.models.convert import decoder_to_jax
    from ddsp_tpu_torch.ops.cuda.osc_frames import variant_name
    from ddsp_tpu_torch.ops.fir import PRNGKey
    from ddsp_tpu_torch.parallel.launch import run_ranks

    conf = Config(**worker.SP_KW)
    case = dict(kind="sp", conf=worker.SP_KW, ranks=8, n_data=2, n_time=4,
                steps=worker.SP_STEPS, batch=worker.sp_batch(),
                params=decoder_to_jax(decoder_init(conf, seed=0)), rng=PRNGKey(0).numpy())
    ranks = [r["sp"] for r in run_ranks(cases.run_cases, 8, ({"sp": case},), backend="gloo",
                                        device="cuda", timeout=300, group_timeout=60)]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        np.testing.assert_array_equal(r["checksum"], ranks[0]["checksum"])
        for c in r["counts"]:
            assert (c.get("osc_frames_fwd") == c.get(variant_name("osc_frames_fwd", "rot")) == 1
                    and c.get("osc_frames_bwd") == c.get(variant_name("osc_frames_bwd", "rot"))
                    == 1), c
    got = ranks[0]
    start = {k: torch.as_tensor(v) for k, v in
             cases.case_state(case, conf, "cpu").params.state_dict().items()}
    starts = [start] + [{k: torch.from_numpy(v) for k, v in p.items()}
                        for p in got["params"][:-1]]
    names = [k for k, _ in cases.case_state(case, conf, "cpu").params.named_parameters()]
    for i, (fm, fparams, sm, sgrads) in enumerate(cases.single_steps(case, starts, cuda_device)):
        m = got["metrics"][i]
        assert abs(m["loss"] - fm["loss"]) <= 1e-4 * abs(fm["loss"]), (i, m, fm)
        assert abs(m["loss"] - sm["loss"]) <= 1e-4 * abs(sm["loss"]), (i, m, sm)
        assert abs(m["grad_norm"] - sm["grad_norm"]) <= 1e-3 * sm["grad_norm"], (i, m, sm)
        total = np.sqrt(sum(float((g * g).sum()) for g in sgrads))
        for k, g, w in zip(names, got["grads"][i], sgrads):
            diff = np.linalg.norm(g - w)
            assert diff <= 5e-3 * np.linalg.norm(w) + 1e-6 * total, (i, k, diff)
        for k, v in fparams.items():
            np.testing.assert_allclose(got["params"][i][k], v, rtol=2e-3, atol=2e-5,
                                       err_msg=f"step {i} {k}")
