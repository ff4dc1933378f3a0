"""The traffic generators repeat exactly by seed, give every seed the
same set of sizes and arrivals, and follow their stated distributions."""
from __future__ import annotations

import numpy as np

from portbench import harness
from portbench.generators import requests, token_file
from portbench.tests.tiny import REPO

MIXES = REPO / "portbench" / "traffic"
CLOSED = harness.load_json(MIXES / "gen-closed-256.json")
OPEN = harness.load_json(MIXES / "gen-open-r80.json")
V = 50257


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.prompt, y.prompt) and x.out_len == y.out_len
        and x.at == y.at for x, y in zip(a, b))


def test_requests_repeat_by_seed():
    for mix in (CLOSED, OPEN):
        a = requests.plan(mix, 2**31 + 7, 30, V)
        b = requests.plan(mix, 2**31 + 7, 30, V)
        c = requests.plan(mix, 5, 30, V)
        assert _same(a, b)
        assert not _same(a, c)


def test_every_seed_serves_the_same_sizes_and_gaps():
    for mix in (CLOSED, OPEN):
        a = requests.plan(mix, 1, 30, V)
        b = requests.plan(mix, 99, 30, V)
        assert sorted((len(r.prompt), r.out_len) for r in a) == \
            sorted((len(r.prompt), r.out_len) for r in b)
    ga = np.diff([0.0] + [r.at for r in requests.plan(OPEN, 1, 30, V)])
    gb = np.diff([0.0] + [r.at for r in requests.plan(OPEN, 99, 30, V)])
    assert np.allclose(np.sort(ga), np.sort(gb))


def test_every_whole_block_from_the_start_is_the_same_set():
    block = CLOSED["block"]
    a = requests.plan(CLOSED, 1, 30, V)
    b = requests.plan(CLOSED, 2**31 + 99, 30, V)
    for n in (block, 5 * block, 13 * block):
        assert sorted((len(r.prompt), r.out_len) for r in a[:n]) == \
            sorted((len(r.prompt), r.out_len) for r in b[:n])
    assert [r.out_len for r in a[:block]] != [r.out_len for r in b[:block]]
    ta = [r.at for r in requests.plan(OPEN, 1, 30, V)]
    tb = [r.at for r in requests.plan(OPEN, 2**31 + 99, 30, V)]
    assert ta == tb


def test_length_distributions():
    reqs = requests.plan(CLOSED, 3, 30, V)
    assert len(reqs) == CLOSED["pool"]
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.out_len for r in reqs])
    assert p.min() >= 16 and p.max() <= 256
    assert abs(np.median(p) - 96) <= 4
    assert o.min() >= 256 and o.max() <= 768
    assert abs(o.mean() - 512) < 6
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < V
    assert abs(ids.mean() - (V - 1) / 2) < 0.01 * V


def test_poisson_arrivals():
    rate = OPEN["arrivals"]["rate"]
    reqs = requests.plan(OPEN, 3, 30, V)
    at = np.array([r.at for r in reqs])
    assert np.all(np.diff(at) > 0) and at[-1] <= 30
    assert abs(len(at) - rate * 30) < 4 * np.sqrt(rate * 30)
    gaps = np.diff(np.concatenate([[0.0], at]))
    assert abs(gaps.mean() * rate - 1) < 0.1
    # exponential: the coefficient of variation is about 1
    assert 0.8 < gaps.std() / gaps.mean() < 1.2


def test_token_file(tmp_path):
    a = token_file.write(tmp_path / "a.bin", 100_000, V, 2**31 + 3)
    b = token_file.write(tmp_path / "b.bin", 100_000, V, 2**31 + 3)
    assert a.read_bytes() == b.read_bytes()
    toks = np.fromfile(a, np.uint16)
    assert len(toks) == 100_000 and toks.max() < V
    d, lab = token_file.windows(a, [0, 500], 16)
    assert np.array_equal(d[1], toks[500:516])
    assert np.array_equal(lab[1], toks[501:517])
