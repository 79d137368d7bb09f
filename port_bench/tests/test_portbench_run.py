"""A whole run on the CPU at a small size (the look for a card skipped):
it is correct as it stands and not correct with the timed path broken
underneath; a module of JAX or of the JAX package stops it."""
import json
import sys
import types

import pytest

from port_bench import manifest, run

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _run(capsys, cell, tiny, limits, **kw):
    overrides = {"graph": tiny, "limits": limits(manifest.resolve(manifest.load(), cell))}
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds", "0.5",
                   "--trace", "0"], require_chip=False, device="cpu", overrides=overrides, **kw)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell, tiny, tiny_limits):
    rc, out, err = _run(capsys, cell, tiny, tiny_limits)
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"], err
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ")


def _state_unchanged(prog):
    prog.optimizer.step = lambda *a, **k: None


def _half_batch(monkeypatch):
    from kagnn_tpu_torch.train import losses

    real = losses.masked_softmax_cross_entropy

    def half(logits, labels, mask):
        keep = mask & (mask.long().cumsum(0) <= int(mask.sum()) // 2)
        return real(logits, labels, keep)

    monkeypatch.setattr(losses, "masked_softmax_cross_entropy", half)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(capsys, monkeypatch, cell, fault, tiny, tiny_limits):
    hook = None
    if fault == "state_unchanged":
        hook = _state_unchanged
    else:
        _half_batch(monkeypatch)
    rc, out, err = _run(capsys, cell, tiny, tiny_limits, program_hook=hook)
    assert rc == 0
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False


def test_forbidden_module_stops_the_run(capsys, monkeypatch, tiny, tiny_limits):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kagnn_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []  # names compared whole
    rc, out, err = _run(capsys, CELLS[0], tiny, tiny_limits, program_hook=lambda prog: sys.modules.setdefault(
        "jax.numpy", types.ModuleType("jax.numpy")))
    sys.modules.pop("jax.numpy", None)
    assert rc == 4 and out.strip() == "" and "jax" in err


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err
