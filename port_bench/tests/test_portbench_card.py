"""Each cell on the card for a short window: it builds, runs, reads its
trace and comes out correct. Needs a CUDA device (the `card` fixture)."""
import json

import pytest

from port_bench import manifest, run

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", "4000000017", "--seconds", "2",
                   "--trace", str(trace)])
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"], err
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
