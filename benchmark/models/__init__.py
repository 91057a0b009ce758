"""The benchmark's models: one module each, ``benchmark/models/<name>.py``,
found by the name in a configuration file's ``model`` key, or
``ddsp_decoder`` where the file has none (``Registry.config_model``).

A model module holds everything of a cell that names a module of the
program or a leaf of its weights.  The cell drivers (``<kind>_cell.py``)
hold what is the cell's: set-up timing, the check's steps or warm-up
calls, the timed loop, the profiler window, the memory peak, the hand-off
to ``judge`` and the control.  They read from the configuration only its
sizes: ``hop_length``, ``sample_rate``, ``frames`` and ``log_every``.

``ctx`` is the run's context (``run.card_context``, or the tests'
``tiny.cpu_context``): ``model``, ``conf``, ``cd``, ``mix``, ``seed``,
``device`` and the rest.  A model module gives:

``config(fields) -> conf``
    The program's configuration from a configuration file's fields; the
    benchmark's own keys (``model``, ``assumed``, ``published``) dropped.
``as_dict(conf) -> dict``
    The configuration as the counts, the reference and the drivers read
    it, with ``frames``, the frames of one example.
``device(name) -> torch.device``
    The device by name ("cuda", "cpu"), with the precision the
    configuration states set on it.
``STAGES``
    {traffic kind: the names of the program's stage ranges on that path},
    which the traced window charges the device's operations to.

A training cell (``train_cell.py``):

``train_inputs(ctx) -> namespace``
    All that is drawn from the seed and handed to both sides: ``batches``,
    the list of step inputs the window cycles, and whatever else the
    program's start and the reference take (weights, keys).
``train_program(ctx, inputs) -> namespace``
    The program built from those: ``step``, a function (state, batch) ->
    (state, metrics with a ``loss`` tensor), and ``state``, its first
    state.  The driver hands ``step`` to ``ctx.tamper``.
``train_grad(program, state) -> {leaf: norm}``
    After the first step: the first gradient as the optimizer took it.
``train_change(program, inputs) -> {leaf: norm}``
    The parameters' change since the start.
``train_counts(ctx) -> dict``
    The traced window's context: ``unit_flops`` of a step and the bounds
    its per-layer readers take, from ``benchmark/counts.py``.
``train_reference(ctx, inputs) -> dict``
    The plain reference's first ``check_steps`` steps from the same
    inputs: {'loss': [...], 'grad1': {leaf: norm}, 'change': {leaf: norm}}.
``train_release(ctx)``
    Put back any process-wide switch ``train_program`` set.

A serving cell (``serve_cell.py``):

``serve_inputs(ctx) -> namespace``
    The weights drawn from the seed, which the program and the reference
    take.
``serve_program(ctx, inputs) -> server``
    The program: ``server.process(blocks)`` takes one call's (slots, hop)
    blocks and returns the (slots, hop) output as a numpy array.  The
    driver hands the server to ``ctx.tamper``.
``serve_traffic(ctx) -> numpy array``
    (calls, slots, hop): the blocks each call sends, drawn from the seed
    after the server is built, and cycled.
``serve_kept(server) -> object``
    What the check follows of the call just made, left on the device.
``serve_followed(kept, slots) -> dict``
    The kept values of every call for the sampled ``slots`` (a device
    tensor), as (S, K) tensors; ``phase``, the oscillator's phase after
    each call, is among them (``judge.serving_numbers``).
``serve_counts(ctx) -> dict``
    The traced window's context, as ``train_counts``.
``serve_reference(ctx, inputs, blocks, followed, slots) -> dict``
    The plain reference's replay of the sampled slots over the (S, K,
    hop) ``blocks``, following ``followed`` (the program's, or a replay's
    own, which carries the same keys), or its own decisions where that is
    None: ``out`` (S, K, hop), the followed values, and what
    ``judge.serving_numbers`` reads.
"""
