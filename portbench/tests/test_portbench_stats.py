"""The tail and the rate: over every event and the whole window, so a stall
in the window moves both."""

from pblib.stats import percentile, rate


def test_percentile_interpolates_over_all_values():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95.05
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(reversed(xs)), 50) == 50.5


def test_a_stall_moves_tail_and_rate():
    lat = [0.06] * 400
    window = sum(lat)
    base_tail, base_rate = percentile(lat, 95), rate(len(lat), window)
    stalled = lat[:]
    for k in range(0, 400, 19):          # 22 events, 5.5%, each 0.2 s late
        stalled[k] += 0.2
    assert percentile(stalled, 95) > base_tail + 0.1
    assert rate(len(stalled), sum(stalled)) < base_rate * 0.9
