"""The generator draws the same faults from the same seed, other faults
from other seeds, and the same amount of work from every seed."""
import json

import numpy as np
import pytest

from portbench.traffic import generate

MIXES = ["crash-burst-1pct", "ingress-partition-1pct", "contested-3camps"]


def _plain(descs):
    return json.dumps(descs, sort_keys=True, default=lambda a: a.tolist())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_description(name):
    traffic = generate.load(name)
    a = generate.fleet(traffic, 1000, 4, 2**31 + 12345)
    b = generate.fleet(traffic, 1000, 4, 2**31 + 12345)
    assert _plain(a) == _plain(b)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_description(name):
    traffic = generate.load(name)
    a = generate.fleet(traffic, 1000, 4, 7)
    b = generate.fleet(traffic, 1000, 4, 8)
    assert _plain(a) != _plain(b)
    # members of one fleet differ from each other too
    assert _plain(a[0]) != _plain(a[1])


def test_every_seed_the_same_work():
    traffic = generate.load("crash-burst-1pct")
    for seed in (0, 1, 2**31 - 1, 2**31 + 5, 2**40 + 3):
        for desc in generate.fleet(traffic, 100_000, 2, seed):
            assert len(desc["crashes"]) == 1000
            assert {t for _, t in desc["crashes"]} == {5}
            assert len({s for s, _ in desc["crashes"]}) == 1000
    traffic = generate.load("ingress-partition-1pct")
    for seed in (3, 2**33):
        (w,) = generate.member(traffic, 1000, seed, 0)["windows"]
        assert len(w["dst"]) == 10 and len(w["src"]) == 990
        assert not set(w["dst"]) & set(w["src"])
        assert (w["start"], w["period"], w["two_way"]) == (5, 200, False)
    traffic = generate.load("contested-3camps")
    for seed in (9, 2**35 + 1):
        prop = generate.member(traffic, 100_000, seed, 0)["proposes"]
        delay = np.sort(prop["delay"])
        assert delay[0] == 10 and delay[1] >= 15 and delay.size == 100_000
        assert len(prop["victims"]) == 3 and prop["tick"] == 5
        assert set(np.unique(prop["camp"])) == set(range(len(
            prop["victims"])))


def test_unknown_key_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(generate, "HERE", tmp_path)
    (tmp_path / "bad.json").write_text('{"meteor": {}}')
    with pytest.raises(ValueError):
        generate.load("bad")
