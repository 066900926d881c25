"""The window's arithmetic: frame_ms is the window over the frames, and
frame_ms_p95 is taken over every frame of the window."""

import pytest

from portbench.harness import window


def test_frame_ms_is_window_over_frames():
    # 10 frames in 1.25 s: 125 ms a frame whatever their spread
    assert window.frame_ms(1.25, 10) == pytest.approx(125.0)


def test_frame_ms_counts_a_stall():
    steady = [0.08] * 99
    stalled = steady + [0.5]
    # a median would not move; the window's mean does
    assert window.frame_ms(sum(stalled), 100) == pytest.approx(
        (0.08 * 99 + 0.5) * 10)
    assert window.frame_ms(sum(stalled), 100) > window.frame_ms(
        sum(steady) + 0.08, 100)


@pytest.mark.parametrize("n,stalls,want", [
    (100, 0, 80.0),    # no stall: the common frame
    (100, 5, 80.0),    # 5 stalls of 100 frames lie beyond the 95th
    (100, 6, 500.0),   # the sixth reaches it
    (20, 1, 80.0),     # 1 stall in 20: exactly the top 5%
    (1, 0, 80.0),      # one frame is its own percentile
])
def test_p95_over_all_frames(n, stalls, want):
    frames = [0.08] * (n - stalls) + [0.5] * stalls
    assert window.p95_ms(frames[::-1]) == pytest.approx(want)


def test_empty_window_raises():
    with pytest.raises(ValueError):
        window.frame_ms(1.0, 0)
    with pytest.raises(ValueError):
        window.p95_ms([])
