"""The comparison and AP on hand-worked answers."""
import math

import pytest
import torch

from rangebench.harness import judge, reference

LIMITS = {"bad_rows": 0, "range_excess": 1e-6, "dist_over": 1e-6, "dist_under": 1e-6,
          "recall": 0.5}
# five points on a line; squared l2 from the query at 0: 0, 1, 4, 9, 16
POINTS = torch.tensor([[0.0], [1.0], [2.0], [3.0], [4.0]])
PAD = 2**31 - 1


def _truth(r=4.0):
    q = torch.zeros(1, 1)
    radii = torch.tensor([r])
    return {0: judge.Truth(queries=q, radii=radii,
                           counts=reference.true_counts(POINTS, q, radii, "l2"))}


def _ans(ids, dists, count):
    k = 4
    ids = ids + [PAD] * (k - len(ids))
    dists = dists + [math.inf] * (k - len(dists))
    return judge.Answer(index=0, ids=torch.tensor([ids], dtype=torch.int32),
                        dists=torch.tensor([dists]), count=torch.tensor([count], dtype=torch.int32))


def _judge(ans, limits=LIMITS):
    return judge.judge(POINTS, "l2", [ans], _truth(), limits)


def test_rangebench_true_counts():
    assert int(_truth()[0].counts[0]) == 3          # 0, 1, 4 within r = 4


def test_rangebench_exact_answer_is_correct():
    v = _judge(_ans([0, 1, 2], [0.0, 1.0, 4.0], 3))
    assert v.correct and v.readings == dict(bad_rows=0, range_excess=0.0, dist_over=0.0,
                                            dist_under=0.0, recall=1.0, ap=1.0)


def test_rangebench_ap_is_size_weighted():
    # two of three found: 2/3; and two queries weigh by their true counts
    assert _judge(_ans([0, 2], [0.0, 4.0], 2)).readings["ap"] == pytest.approx(2 / 3)
    q = torch.tensor([[0.0], [4.0]])
    radii = torch.tensor([4.0, 1.0])
    truths = {0: judge.Truth(queries=q, radii=radii,
                             counts=reference.true_counts(POINTS, q, radii, "l2"))}
    ans = judge.Answer(index=0, ids=torch.tensor([[0, PAD], [4, 3]], dtype=torch.int32),
                       dists=torch.tensor([[0.0, math.inf], [0.0, 1.0]]),
                       count=torch.tensor([1, 2], dtype=torch.int32))
    v = judge.judge(POINTS, "l2", [ans], truths, LIMITS)
    assert v.readings["ap"] == pytest.approx(3 / 5)   # (1 + 2) / (3 + 2)
    # recall: lane 0 found 1 of the 2 its capacity K = 2 can hold, lane 1
    # both of its 2: (1/2 + 1) / 2
    assert v.readings["recall"] == pytest.approx(3 / 4)


def test_rangebench_an_answer_outside_the_radius():
    v = _judge(_ans([0, 1, 3], [0.0, 1.0, 9.0], 3))
    assert v.readings["range_excess"] == pytest.approx(1.25)   # (9 - 4) / 4
    assert not v.correct and v.failed == 1


def test_rangebench_a_wrong_distance():
    v = _judge(_ans([0, 1], [0.0, 1.5], 2))
    assert v.readings["dist_over"] == pytest.approx(0.125)     # (1.5 - 1) / 4
    assert v.readings["dist_under"] == 0.0 and not v.correct
    # a distance below the exact one: a lower bound passes only within its cap
    low = _ans([0, 1], [0.0, 0.5], 2)
    assert _judge(low).readings["dist_under"] == pytest.approx(0.125)
    assert not _judge(low).correct
    assert _judge(low, dict(LIMITS, dist_under=0.2)).correct
    assert not _judge(low, dict(LIMITS, dist_under=0.1)).correct


@pytest.mark.parametrize("ids,dists,count", [
    ([0, 0], [0.0, 0.0], 2),          # an id twice
    ([0, 7], [0.0, 1.0], 2),          # an id outside the corpus
    ([0, 1], [0.0, 1.0], 1),          # a corpus id after the count
    ([0], [0.0], 5),                  # a count past K
    ([0, 1], [0.0, math.inf], 2),     # no finite distance
])
def test_rangebench_bad_rows(ids, dists, count):
    v = _judge(_ans(ids, dists, count))
    assert v.readings["bad_rows"] == 1 and not v.correct


def test_rangebench_lost_answers_fail_recall():
    v = _judge(_ans([], [], 0))
    assert v.readings["recall"] == 0.0 and not v.correct
    # capped recall: a lane whose capacity K=4 holds all it can has found all
    q = torch.zeros(1, 1)
    radii = torch.tensor([100.0])
    truths = {0: judge.Truth(queries=q, radii=radii,
                             counts=reference.true_counts(POINTS, q, radii, "l2"))}
    full = _ans([0, 1, 2, 3], [0.0, 1.0, 4.0, 9.0], 4)
    assert judge.judge(POINTS, "l2", [full], truths, LIMITS).readings["recall"] == 1.0


def test_rangebench_an_empty_window_is_not_correct():
    v = judge.judge(POINTS, "l2", [], {}, LIMITS)
    assert not v.correct


def test_rangebench_repeats_count_once_in_ap():
    a = _ans([0, 2], [0.0, 4.0], 2)
    v = judge.judge(POINTS, "l2", [a, a, a], _truth(), LIMITS)
    assert v.readings["ap"] == pytest.approx(2 / 3) and v.lanes == 3 and v.distinct == 1


def test_rangebench_pair_dists_are_float64():
    ids = torch.tensor([[1, 4]], dtype=torch.int32)
    d = reference.pair_dists(POINTS, torch.zeros(1, 1), ids,
                             torch.tensor([[True, False]]), "l2")
    assert d.dtype == torch.float64 and d[0, 0] == 1.0 and math.isinf(d[0, 1])


@pytest.mark.parametrize("kind", ["tf32", "int4"])
def test_rangebench_control_layout(kind):
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(300, 16, generator=g)
    qs = pts[:5] + 0.01
    ids, dists, count = reference.control(kind, pts, qs, torch.full((5,), 8.0), 8, "l2")
    assert ids.shape == (5, 8) and dists.shape == (5, 8)
    for lane in range(5):
        c = int(count[lane])
        assert c <= 8 and (ids[lane, :c] >= 0).all() and (ids[lane, c:] == -1).all()
        assert (dists[lane, :c].diff() >= 0).all()


def test_rangebench_tf32_rounding():
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10 + 2**-12, 3.0])
    got = reference._tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2**-10 and got[2] == 3.0


def test_rangebench_repeats_weigh_by_times():
    a = _ans([0, 2], [0.0, 4.0], 2)
    a.times = 3
    bad = _ans([0, 2], [0.0, 1.0], 2)      # a later answer that differed
    v = judge.judge(POINTS, "l2", [a, bad], _truth(), LIMITS)
    assert v.lanes == 4 and v.failed == 1 and v.distinct == 1
    assert v.readings["ap"] == pytest.approx(2 / 3) and not v.correct


def test_rangebench_digest():
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 1000, (5000, 16), generator=g, dtype=torch.int32)
    dists = torch.rand((5000, 16), generator=g)
    count = torch.randint(0, 17, (5000,), generator=g, dtype=torch.int32)
    h = int(judge.digest(ids, dists, count))
    assert h == int(judge.digest(ids.clone(), dists.clone(), count.clone()))
    # the order of a lane's slots does not count
    perm = torch.randperm(16, generator=g)
    assert h == int(judge.digest(ids[:, perm], dists[:, perm], count))
    # any id, distance bit or count does, in any block of lanes
    for lane in (0, 2047, 2048, 4999):
        i2, d2, c2 = ids.clone(), dists.clone(), count.clone()
        i2[lane, 3] += 1
        d2[lane, 5] = torch.nextafter(d2[lane, 5], torch.tensor(2.0))
        c2[lane] += 1
        assert int(judge.digest(i2, dists, count)) != h
        assert int(judge.digest(ids, d2, count)) != h
        assert int(judge.digest(ids, dists, c2)) != h
    # two lanes swapped
    swap = torch.arange(5000)
    swap[[10, 11]] = swap[[11, 10]]
    assert int(judge.digest(ids[swap], dists[swap], count[swap])) != h
