"""The port's spans on its serving and training paths (``utils/profiling``).

On the CPU, at the narrow widths of the serving-tools and training tests:

* a ``MultiStreamServer.process`` call inside a profiler window records
  ``process``, ``copy_in``, ``hop``, ``copy_out``, ``state`` and the
  features' three parts once each, and its copies and issue fit inside
  ``process``;
* a decoder train step records ``train_step`` and the five
  ``backward.<stage>`` spans once each, in the order autograd runs the
  stages' backwards;
* the backward spans hold their stages' nodes: the ``backward.<stage>``
  range around each autograd node's own event (``XBackward0``, not its
  ``evaluate_function`` wrapper) is that of the forward range around the
  forward op of the same sequence number, for at least 95 % of the nodes;
* the serving step, which selects its filling slots' controls after the
  render inside the one ``state`` span, is bit-equal, output and state, to
  the step that selected them before the render, also after a slot is
  reset mid-stream with a former stream's controls left stored.

The tests marked ``cuda`` hold the spans' device seconds against the trace
on the card: the features' parts against the ``features`` range, the
backward's stages against the ``backward`` range; the spans without
``device=True`` time nothing there.  This file imports no jax:
``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import time

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.models.controller import controller_apply, decoder_init
from ddsp_tpu_torch.models.crepe import crepe_init
from ddsp_tpu_torch.models.synths import ReverbLiveState, reverb_ir_spectra
from ddsp_tpu_torch.ops.fir import PRNGKey
from ddsp_tpu_torch.runtime import multistream
from ddsp_tpu_torch.runtime.multistream import MultiStreamServer
from ddsp_tpu_torch.runtime.streaming import make_feature_stream_step
from ddsp_tpu_torch.training import trainer
from ddsp_tpu_torch.utils import profiling

SERVE_CONF = Config(
    sample_rate=4000, n_fft=256, hop_length=64, n_harmonics=12, n_noise_filters=9,
    decoder_mlp_units=16, decoder_mlp_layers=1, decoder_gru_units=16, reverb_length=300,
)
TRAIN_CONF = Config(
    sample_rate=4000, n_fft=256, hop_length=64, example_duration=0.5,
    n_harmonics=16, n_noise_filters=17, decoder_mlp_units=32,
    decoder_mlp_layers=1, decoder_gru_units=32, batch_size=4,
    mss_ffts=(256, 128, 64), checkpoint_every=0, log_every=5,
)
# the serving spans whose device seconds a metric reads, then the host-only ones
DEVICE_SPANS = ("state", "features.loudness", "features.resample", "features.crepe")
SERVE_SPANS = DEVICE_SPANS + ("process", "copy_in", "hop", "copy_out")
# the decoder's stages, in the order the backward reaches them
STAGES = ("loss", "reverb", "filtered_noise", "oscillator_bank", "controller")
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_span_log():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _server(conf, n, device):
    return MultiStreamServer(decoder_init(conf, 0), crepe_init(conf.crepe_capacity, 1),
                             conf, n, noise_seed=3, device=device)


def _blocks(conf, n, calls, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((calls, n, conf.hop_length))).astype(np.float32)


def _train(conf, batch_size, device, seed=0):
    state = trainer.init_state(PRNGKey(seed, "cpu"), conf, device=device)
    rng = np.random.default_rng(seed)
    t, n = conf.frames_per_example, batch_size

    def feature(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, (n, t, 1)).astype(np.float32), device=device)

    batch = {"f0": feature(100, 400), "normalized_cents": feature(0, 1),
             "loudness": feature(0, 1),
             "audio": torch.tensor((0.1 * rng.standard_normal((n, conf.example_length)))
                                   .astype(np.float32), device=device)}
    return trainer.make_train_step(conf), state, batch


def test_serving_call_records_each_span_once():
    server = _server(SERVE_CONF, 3, "cpu")
    blocks = _blocks(SERVE_CONF, 3, 4)
    server.process(blocks[0])
    assert profiling.span_records() == []  # no window, no record
    with torch.profiler.profile(activities=CPU):
        for b in blocks[1:]:
            server.process(b)
    totals = profiling.span_totals()
    for name in SERVE_SPANS + ("features", "controller", "oscillator", "noise", "reverb"):
        assert totals[name]["count"] == 3, name
    records = profiling.span_records()
    calls = [r for r in records if r[0] == "process"]
    for a, b in ((r[1], r[2]) for r in calls):
        parts = [r for r in records if r[0] in ("copy_in", "hop", "copy_out")
                 and a <= r[1] and r[2] <= b]
        assert [r[0] for r in parts] == ["copy_in", "hop", "copy_out"]
        assert sum(r[2] - r[1] for r in parts) <= b - a
    host = {k: v["host_s"] for k, v in totals.items()}
    assert host["features.loudness"] + host["features.resample"] + host["features.crepe"] \
        <= host["features"]


def _select_before_render_step(params, crepe, conf, noise_key):
    """The serving step as it was before the ``state`` span: the filling
    slots' controls snapped to the incoming frame before the render."""
    feat_step = make_feature_stream_step(crepe, conf)
    slot_keys = multistream._row_keys(noise_key, False)
    with torch.no_grad():
        ir_spec = reverb_ir_spectra(params.reverb, conf, conf.hop_length)

    @torch.no_grad()
    def step(state, blocks):
        frame, feat = feat_step(state.feat, blocks)
        controls, hidden = controller_apply(params.controller, frame, state.hidden)
        new_ctrl = {k: controls[k] for k in ("f0", "c", "a")}
        first = (state.n_seen == 0)[:, None, None]
        prev_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.prev.items()}
        cur_r = {k: torch.where(first, new_ctrl[k], v) for k, v in state.cur.items()}
        wet, phase, hist = multistream._render_slots(
            params, conf, ir_spec, slot_keys(blocks.shape[0]), prev_r, cur_r, new_ctrl,
            state.phase, state.pending["H"], state.n_seen, state.reverb_hist)
        have_output = state.n_seen >= 1
        return torch.where(have_output[:, None], wet, 0.0), multistream.MultiStreamState(
            feat=feat, hidden=hidden, phase=torch.where(have_output, phase, state.phase),
            prev=cur_r, cur=new_ctrl, pending={"H": controls["H"]}, n_seen=state.n_seen + 1,
            reverb_hist=ReverbLiveState(*(
                torch.where(have_output.reshape((-1,) + (1,) * (h.dim() - 1)), h, o)
                for h, o in zip(hist, state.reverb_hist))))

    return step


def test_state_span_step_equals_selecting_before_the_render():
    conf, n = SERVE_CONF, 4
    params, crepe = decoder_init(conf, 0).eval(), crepe_init(conf.crepe_capacity, 1).eval()
    key = PRNGKey(3, "cpu")
    steps = (multistream.make_multistream_step(params, crepe, conf, key),
             _select_before_render_step(params, crepe, conf, key))
    states = [multistream.multistream_init(conf, n, "cpu")] * 2
    for i, b in enumerate(torch.from_numpy(_blocks(conf, n, 9))):
        if i == 5:  # a new client takes slot 2: its pipeline refills, the
            # former stream's controls still stored
            states = [multistream.reset_slots(conf, s, [2])._replace(prev=s.prev, cur=s.cur)
                      for s in states]
            assert not torch.equal(states[0].cur["f0"][2], torch.zeros_like(states[0].cur["f0"][2]))
        (out, new), (out_ref, ref) = (step(s, b) for step, s in zip(steps, states))
        assert torch.equal(out, out_ref), i
        for a, r in zip(tree_leaves(new), tree_leaves(ref), strict=True):
            assert torch.equal(a, r), i
        states = [new, ref]


def test_train_step_records_the_backward_spans_in_engine_order():
    step, state, batch = _train(TRAIN_CONF, 4, "cpu")
    state, _ = step(state, batch)
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            state, _ = step(state, batch)
    names = [r[0] for r in profiling.span_records()]
    backward = [n for n in names if n.startswith("backward.")]
    assert backward == [f"backward.{s}" for s in STAGES] * 2
    assert names.count("train_step") == 2 and names[-1] == "train_step"
    # each step's backward spans close inside its backward range
    records = profiling.span_records()
    for a, b in ((r[1], r[2]) for r in records if r[0] == "backward"):
        inside = [r[0] for r in records if r[0].startswith("backward.")
                  and a <= r[1] and r[2] <= b]
        assert inside == [f"backward.{s}" for s in STAGES]


def _holder(ranges):
    """time ns -> the innermost of ``ranges`` [(start, end, name)] holding it."""
    ranges = sorted(ranges)

    def at(t):
        held = [n for a, b, n in ranges if a <= t <= b]
        return held[-1] if held else None
    return at


def test_backward_spans_hold_their_stages_nodes():
    step, state, batch = _train(TRAIN_CONF, 4, "cpu")
    state, _ = step(state, batch)
    with torch.profiler.profile(activities=CPU) as prof:
        step(state, batch)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    forward_at = _holder([(e.start_ns(), e.end_ns(), e.name()) for e in events
                          if e.name() in STAGES])
    backward_at = _holder([(e.start_ns(), e.end_ns(), e.name()) for e in events
                           if e.name().startswith("backward.")])
    backward_start = min(e.start_ns() for e in events if e.name() == "backward")
    # a node's sequence number is the one its forward op recorded last: ops
    # that made no node before it record the same number
    made_by = {}
    nodes = []
    for e in events:
        if e.sequence_nr() < 0 or e.name().startswith("autograd::"):
            continue
        if "Backward" in e.name():
            nodes.append(e)
        elif backward_start > e.start_ns() >= made_by.get(e.sequence_nr(), (-1,))[0]:
            made_by[e.sequence_nr()] = (e.start_ns(), e.name())
    assert len(nodes) > 100
    misplaced = []
    for e in nodes:
        stage = forward_at(made_by[e.sequence_nr()][0])
        if backward_at(e.start_ns()) != f"backward.{stage}":
            misplaced.append((e.name(), made_by[e.sequence_nr()][1], stage,
                              backward_at(e.start_ns())))
    assert len(misplaced) <= 0.05 * len(nodes), misplaced


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _window(prof, stages, units):
    from benchmark import tracing  # the benchmark's reader of a window

    return tracing.summarise(prof, stages, 0.0, units, {})


def _bracket(parts_s, range_device_s, range_idle_s):
    """The spans' device seconds against the trace's for their range: at
    least 95 % of the range's kernel time, at most its kernel time and the
    card's idle inside it, plus 5 %."""
    assert 0.95 * range_device_s <= parts_s <= 1.05 * (range_device_s + range_idle_s), \
        (parts_s, range_device_s, range_idle_s)


@pytest.mark.cuda
def test_feature_spans_time_the_features_range_on_card(cuda_device):
    conf = Config()
    server = _server(conf, 512, cuda_device)
    blocks = _blocks(conf, 512, 25)
    for b in blocks[:5]:
        server.process(b)
    torch.cuda.synchronize()
    activities = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for b in blocks[5:]:
            server.process(b)
    w = _window(prof, ("features", "controller", "oscillator", "noise", "reverb"), 20)
    totals = profiling.span_totals()
    for name in SERVE_SPANS:
        assert totals[name]["count"] == 20, name
        assert (totals[name]["device_s"] > 0) if name in DEVICE_SPANS \
            else totals[name]["device_s"] is None, name
    parts = sum(totals[f"features.{p}"]["device_s"] for p in ("loudness", "resample", "crepe"))
    _bracket(parts, w.device_s["features"], dict(w.idle_by_range).get("features", 0.0))


@pytest.mark.cuda
def test_backward_spans_time_the_backward_range_on_card(cuda_device):
    conf = Config(batch_size=16)
    step, state, batch = _train(conf, 16, cuda_device)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    activities = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    w = _window(prof, ("controller", "oscillator_bank", "filtered_noise", "reverb", "loss",
                       "backward", "optimizer"), 4)
    totals = profiling.span_totals()
    for s in STAGES:
        assert totals[f"backward.{s}"]["count"] == 4, s
    parts = sum(totals[f"backward.{s}"]["device_s"] for s in STAGES)
    _bracket(parts, w.device_s["backward"], dict(w.idle_by_range).get("backward", 0.0))
    assert totals["train_step"]["host_s"] <= window_s
