"""The traffic: the same for the same seed, another for another seed."""

import torch

from pblib import traffic

FCFG = {"initial_decompose_cell_cnt": 64, "partial_pattern_cell_cnt": 8,
        "general_pattern_cell_cnt": 8, "partial_pattern_dist": 0.01,
        "general_pattern_dist": 1.0}
RAYS = {"ray_y": 10.0, "ray_radius": [0.8, 1.6], "direction": [0.0, -1.0, 0.0]}


def test_same_seed_same_traffic():
    for seed in (0, 7, 3_000_000_019, 2**70 + 5):
        a = traffic.fracture_seeds(seed, 3, FCFG)
        b = traffic.fracture_seeds(seed, 3, FCFG)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert traffic.down_ray(seed, 5, RAYS) == traffic.down_ray(seed, 5, RAYS)
        assert traffic.sample_index(seed, 32) == traffic.sample_index(seed, 32)


def test_other_seed_or_event_other_traffic():
    a = traffic.fracture_seeds(3_000_000_019, 0, FCFG)[0]
    assert not torch.equal(a, traffic.fracture_seeds(3_000_000_020, 0, FCFG)[0])
    assert not torch.equal(a, traffic.fracture_seeds(3_000_000_019, 1, FCFG)[0])


def test_shapes_and_ranges():
    u, p, g = traffic.fracture_seeds(11, 0, FCFG)
    assert u.shape == (64, 3) and p.shape == (8, 3) and g.shape == (8, 3)
    assert float(u.abs().max()) <= 0.5 and float(p.norm(dim=1).max()) <= 0.5 + 1e-6
    for i in range(200):
        (x, y, z), d = traffic.down_ray(11, i, RAYS)
        r = (x * x + z * z) ** 0.5
        assert 0.8 - 1e-9 <= r <= 1.6 + 1e-9 and y == 10.0 and d == (0.0, -1.0, 0.0)
