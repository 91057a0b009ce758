"""``utils/slot_parity.py`` on the CPU, at the serving tests' small width.

A slot of ``MultiStreamServer`` against its lone stream at batch 1 and at
the server's batch size, the lone stream against itself at the two batch
sizes, and each stage's probe: all within the JAX contract's 1e-5 here
(tests/test_multistream.py), and slot 0 equal to row 0 of its lone stream
run on as many rows as the server has, value for value.
"""

import torch_one_thread  # noqa: F401  (one torch thread a test worker)
import json

import numpy as np
import torch

from ddsp_tpu_torch.config import Config
from ddsp_tpu_torch.utils import slot_parity


def test_slot_parity_decomposes_slot_vs_lone_stream():
    result = slot_parity.run(torch.device("cpu"), Config(**slot_parity.SMALL), n_slots=3,
                             hops=6, check=(0, 2), impls=("auto",))
    slots = result["auto"]
    assert set(slots) == {"0", "2"}
    assert slots["0"]["slot_vs_loneN"] == 0.0
    for got in slots.values():
        assert got["peak"] > 1e-3  # the comparison is of real audio
        for key in ("slot_vs_lone1", "slot_vs_loneN", "lone1_vs_loneN"):
            assert 0.0 <= got[key] <= 1e-5, (key, got[key])
        assert set(got["probes"]) == set(slot_parity.PROBES)
        assert all(np.isfinite(v) and v <= 1e-5 for v in got["probes"].values())


def test_slot_parity_cli_writes_both_fills(tmp_path, capsys):
    out = tmp_path / "parity.json"
    assert slot_parity.main(["--device=cpu", "--slots=2", "--hops=4", "--check=1",
                             f"--out={out}"]) == 0
    written = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == written
    assert (written["slots"], written["hops"]) == (2, 4)
    # the CPU's 'auto' is the exact fill, as 'xla' is
    assert written["auto"] == written["xla"]
