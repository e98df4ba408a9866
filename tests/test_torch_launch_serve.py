"""The port's serving CLI against the JAX package's, both run in process.

``python -m repro_torch.launch.serve`` mirrors ``repro.launch.serve``: the
same flags (plus ``--device``), the same ``[serve]`` lines. At ``--n 448
--queries 64`` each mode runs through both packages' ``main`` (the port's
with ``--device cpu``) and the lines are read back: the selected radius is
equal (the same grid, exact counts), AP within 0.02 (each CLI builds its
own Vamana graph, which may differ, e.g. at the reference's row-0 padding
write, ROADMAP.md §3), and coverage, codes and the final live count equal.
Both CLIs build with ``insert_batch=256`` in place of the default 1024:
at this n every prefix-doubling batch (64, 128, 256; 64 and 48 a shard)
is the same, and each step stops padding its lanes to 1024, which is what
the reference's builds spend their time on here.
"""
import ast
import functools
import re

import pytest
import torch

import repro.launch.serve as jserve
from repro_torch.launch import serve

N = 448
INSERT_BATCH = 256
BASE = ["--n", str(N), "--queries", "64"]
MODES = {
    "default": [],
    "replicated": ["--shards", "4", "--replicas", "2", "--down-replicas", "1:0"],
    "churn": ["--churn", "0.1"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the port's small CPU ops only spin on more, and
    the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


def _read(out: str) -> dict:
    """The numbers both CLIs print, from their ``[serve]`` lines."""
    got = {"radius": re.search(r"\[serve\] selected radius (\S+) ", out).group(1)}
    ap = re.search(r"AP(?:=| vs final live set = )([0-9.]+)", out)
    got["ap"] = float(ap.group(1))
    cov = re.search(r"min coverage=([0-9.]+) codes=(\{.*\})", out)
    if cov:
        got["coverage"], got["codes"] = cov.group(1), cov.group(2)
        got["replication"] = re.search(r"\[serve\] replication: (.*)", out).group(1)
    live = re.search(r"\[serve\] final live index: (\{.*\})", out)
    if live:
        got["live"] = ast.literal_eval(live.group(1))
    return got


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_matches_jax(mode, capsys, monkeypatch):
    for cli in (serve, jserve):
        monkeypatch.setattr(cli, "BuildConfig", functools.partial(
            cli.BuildConfig, insert_batch=INSERT_BATCH))
    argv = BASE + MODES[mode]
    got = _read(_run(serve.main, argv + ["--device", "cpu"], capsys))
    want = _read(_run(jserve.main, argv, capsys))
    assert got["radius"] == want["radius"]
    assert abs(got["ap"] - want["ap"]) <= 0.02, (got["ap"], want["ap"])
    assert got["ap"] > 0.5
    assert got.keys() == want.keys()
    if mode == "replicated":
        assert (got["coverage"], got["codes"]) == (want["coverage"], want["codes"]) == (
            "1.00", "{'replica_lost'}")
        assert got["replication"] == want["replication"]
    if mode == "churn":
        assert got["live"]["n_live"] == want["live"]["n_live"] == N
        assert got["live"] == want["live"]


def test_cli_flags_and_device():
    """The reference's flags parse the same (the port adds ``--device``,
    the card by default), and ``--tier`` forces an int8 corpus."""
    seen = {}

    def spy(args, dev):
        seen.update(vars(args), dev=dev)
        return 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "_churn_main", spy)
        assert serve.main(["--churn", "0.5", "--tier", "--device", "cpu"]) == 0
    assert seen["corpus_dtype"] == "int8" and seen["dev"] == torch.device("cpu")
    assert seen["hedge_ms"] == 0.0 and seen["replicas"] == 1 and seen["max_batch"] == 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--n", "100"])
    ours = set(vars(_parser(serve).parse_known_args([])[0]))
    theirs = set(vars(_parser(jserve).parse_known_args([])[0]))
    assert ours - theirs == {"device"} and theirs <= ours


def _parser(module):
    """The CLI's parser, caught as ``main`` builds it."""
    import argparse
    box = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        box["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            module.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return box["p"]
