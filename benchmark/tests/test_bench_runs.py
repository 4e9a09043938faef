"""Whole runs on the CPU (``run.py --rehearse``: the cell's path at a
tiny size with the kernels' plain forms), sound and with the timed path
broken underneath, and the refusal to measure without a card."""

import json

import pytest
import torch

import run


def _run(capsys, cell, *extra):
    rc = run.main(["--workload", cell, "--seed", "2147483700", "--seconds", "1",
                   "--trace", "0", "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "kitti-train-s2", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["kitti-train-s2", "kitti-serve-bulk", "nyu-serve-online"])
def test_sound_rehearsal(capsys, cell):
    out = _run(capsys, cell)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks" and out["checks"]


def _unchanged(monkeypatch):
    from gdn_tpu_torch.train import steps

    monkeypatch.setattr(steps, "_apply_update", lambda state, loss: None)


def _half_batch(monkeypatch):
    from gdn_tpu_torch.train import steps

    make = steps.make_stage2_step

    def broken(cfg, *a, **k):
        step = make(cfg, *a, **k)

        def half(state, d_net, batch):
            n = batch["depth"].shape[0] // 2
            return step(state, d_net, {key: v[:n] for key, v in batch.items()})

        return half

    monkeypatch.setattr(steps, "make_stage2_step", broken)


def _altered_answer(monkeypatch):
    from gdn_tpu_torch import serving

    encode = serving._encode_u16
    monkeypatch.setattr(serving, "_encode_u16", lambda d: encode(torch.roll(d, 1, 0)))


@pytest.mark.parametrize("cell,fault", [
    ("kitti-train-s2", _unchanged), ("kitti-train-s2", _half_batch),
    ("kitti-serve-bulk", _altered_answer), ("nyu-serve-online", _altered_answer)],
    ids=["train-state-unchanged", "train-half-batch", "bulk-altered", "online-altered"])
def test_broken_path_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(capsys, cell)
    assert out["correct"] is False
