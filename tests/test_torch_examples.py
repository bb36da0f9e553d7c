"""The port's five examples (``repro_torch.examples``), run in-process
through their ``main(argv)`` with ``--device cpu``: what they compute is
deterministic, so each runs twice where that is cheap and gives the same
numbers. ``serve_lm`` is also held to the JAX example: its function,
driven with the JAX example's own seed-0 weights (``examples/serve_lm.py``
run as it is), gives the JAX ``ServeEngine``'s greedy tokens on the same
backlog. ``train_lm`` trains with a checkpoint, resumes from it, and
checks that the loss falls, as the JAX example does."""
import re
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.examples import (moe_placement, partition_snn, quickstart,
                                  serve_lm, train_lm)
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from _jax_caches import fresh_jax_caches  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numbers(text: str) -> list:
    """The printed lines without their wall times (``1.2s``, ``3.0x
    faster``, ``tok/s``), which vary from run to run. The whitespace in
    front of a time goes with it: a padded ``%7.1f`` time is one space
    narrower from 10 s on."""
    keep = []
    for line in text.splitlines():
        if re.search(r"\d+(\.\d+)?s\b|tok/s|faster|wall", line):
            line = re.sub(r"\s*\d+(\.\d+)?s\b|\(\S+x faster\)", "", line)
            line = re.sub(r"wall:.*|[\d.]+ tok/s.*", "", line)
        keep.append(line)
    return keep


def test_numbers_drop_padded_times():
    """Two runs of ``partition_snn`` whose times straddle 10 s print lines
    one space apart; every other number still counts."""
    line = "ours  n_parts=12 conn=345  valid=True {:7.1f}s"
    assert _numbers(line.format(9.9)) == _numbers(line.format(10.1))
    assert _numbers(line.format(9.9)) != _numbers(
        line.replace("345", "346").format(9.9))


@pytest.mark.parametrize("example", [quickstart, partition_snn,
                                     moe_placement])
def test_partitioner_examples_repeat(example, capsys):
    example.main(["--device", "cpu"])
    first = capsys.readouterr().out
    example.main(["--device", "cpu"])
    again = capsys.readouterr().out
    assert first.strip() and _numbers(first) == _numbers(again)
    assert "False" not in first.replace("loads valid: True", "")


def test_serve_lm_main_runs_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "8 ragged requests over 4 slots" in text and "warm:" in text
    assert len(out["tokens"]) == len(serve_lm.BACKLOG)
    for t, w, (_, m) in zip(out["tokens"], out["warm"], serve_lm.BACKLOG):
        assert 1 <= len(t) <= m
        np.testing.assert_array_equal(t, w)
    assert out["generated"].shape == (2, 12)


def test_serve_lm_matches_the_jax_example(capsys):
    """The JAX example run as it is (its seed-0 params, its engine), then
    the port's ``serve_backlog`` on those weights: the same greedy tokens
    a request and the same batched ``generate``."""
    g = runpy.run_path(str(ROOT / "examples" / "serve_lm.py"))
    capsys.readouterr()
    cfg = tget("qwen2-1.5b").smoke()
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, g["params"])))
    out = serve_lm.serve_backlog(cfg, model, device="cpu")
    want = [np.asarray(g["res"][r]) for r in sorted(g["res"])]
    assert len(want) == len(out["warm"]) == len(serve_lm.BACKLOG)
    for got, w in zip(out["warm"], want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(out["generated"], np.asarray(g["out"]))


def test_train_lm_checkpoint_and_resume(tmp_path, capsys):
    """Ten steps with a checkpoint at the end, then ``--resume`` to
    twenty: the resumed run starts at step 10, and each run's loss
    falls (the example's own check)."""
    common = ["--batch", "2", "--seq", "32", "--ckpt-dir",
              str(tmp_path / "ck"), "--device", "cpu"]
    first = train_lm.main(["--steps", "10"] + common)
    assert first.steps == 10 and [s for s, _ in first.losses] == [0, 9]
    resumed = train_lm.main(["--steps", "20", "--resume"] + common)
    assert resumed.steps == 20
    assert [s for s, _ in resumed.losses] == [10, 19]
    text = capsys.readouterr().out
    assert "model: 10." in text and text.count("done:") == 2
    assert (tmp_path / "ck" / "step-00000020").is_dir()
