"""The plain reference against the port's CPU path, at narrow widths:
each cell kind driven as on the card (past the card check), its outputs
judged by the reference."""

from benchmark.tests import tiny


def test_serving_reference_follows_the_port():
    res = tiny.drive(tiny.cpu_context(tiny.SERVE_MIX))
    nums = res["numbers"]
    assert res["attempted"] > 0
    assert nums["crepe_gap"] <= 1e-6
    assert nums["phase_step"] <= 1e-6
    assert nums["audio_err"] <= 1e-5


def test_training_reference_follows_the_port():
    res = tiny.drive(tiny.cpu_context(tiny.TRAIN_MIX))
    nums = res["numbers"]
    assert res["attempted"] > 0
    # the first loss is the forward alone, float32 on both sides
    assert nums["loss_step1"] <= 1e-6
    # later steps and the gradients see the program's bf16 reverb backward
    assert nums["loss_later"] <= 1e-4
    assert nums["grad_leaf"] <= 1e-2
    assert nums["change_leaf"] <= 5e-2

