"""The benchmark's generators: deterministic by seed, the right counts,
and the shapes their sources state."""
import pytest
import torch

from bench import harness
from bench.generators import generate

CONFIGS = ("graph500-kron-s22", "gapbs-urand-s22")


def small(config: str, scale: int = 12) -> dict:
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == config)
    return {**harness.load_json(harness.ROOT / conf["file"]), "scale": scale}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_edges(config, seed):
    a = generate(small(config), seed, "cpu")
    b = generate(small(config), seed, "cpu")
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v) and a.n == b.n


@pytest.mark.parametrize("config", CONFIGS)
def test_other_seed_other_edges(config):
    a = generate(small(config), 1, "cpu")
    b = generate(small(config), 2, "cpu")
    assert not torch.equal(a.u, b.u)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("scale", [4, 10, 13])
def test_counts_and_ranges(config, scale):
    g = generate(small(config, scale), 3, "cpu")
    assert g.n == 2**scale and g.m == 16 * 2**scale
    for t in (g.u, g.v):
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert int(t.min()) >= 0 and int(t.max()) < g.n


def test_full_size_counts():
    cfg = small("graph500-kron-s22", 22)
    assert 2**cfg["scale"] == 4_194_304
    assert cfg["edge_factor"] * 2**cfg["scale"] == 67_108_864


def test_kron_is_skewed_and_urand_is_not():
    def max_over_mean(config):
        g = generate(small(config, 14), 5, "cpu")
        deg = torch.bincount(torch.cat([g.u, g.v]).long(), minlength=g.n)
        return float(deg.max()) / float(deg.float().mean())

    assert max_over_mean("graph500-kron-s22") > 20
    assert max_over_mean("gapbs-urand-s22") < 3


def test_kron_quadrant_shares():
    """The top bit of the unpermuted endpoints falls in each quadrant with
    the probabilities A, B, C and D."""
    cfg = {**small("graph500-kron-s22", 12), "permute_labels": False}
    g = generate(cfg, 11, "cpu")
    top = 1 << 11
    hu, hv = (g.u & top) > 0, (g.v & top) > 0
    shares = [float(((hu == a) & (hv == b)).float().mean())
              for a, b in ((False, False), (False, True), (True, False),
                           (True, True))]
    for got, want in zip(shares, (0.57, 0.19, 0.19, 0.05)):
        assert abs(got - want) < 0.01


def test_kron_keeps_self_loops_and_repeats():
    g = generate(small("graph500-kron-s22", 12), 1, "cpu")
    assert int((g.u == g.v).sum()) > 0
    keys = g.u.long() * g.n + g.v.long()
    assert torch.unique(keys).numel() < g.m
