"""The device's idle share as ``chip_smoke.py`` measures it
(``deeparc_tpu_torch.scripts``: ``busy_in``, ``idle_share``,
``loop_window``), on intervals made up here: busy is the union of the
device's activities clipped to a window on the device's own clock, the
window of an LM loop is mapped onto that clock through the correlation
ids of the runtime calls the host made inside the loop, and a share
outside [0, 1] raises."""

import pytest

from deeparc_tpu_torch.scripts import busy_in, idle_share, loop_window


@pytest.mark.parametrize("intervals,lo,hi,busy", [
    # overlapping intervals count once
    ([(0, 5), (4, 12), (15, 30)], 2, 20, 15),
    # a kernel past the window's end is clipped to it
    ([(0, 8), (8, 25)], 0, 10, 10),
    # one that ends before the window or starts after it counts nothing
    ([(-5, -1), (11, 14), (2, 3)], 0, 10, 1),
    ([], 0, 10, 0),
])
def test_busy_is_the_union_clipped_to_the_window(intervals, lo, hi, busy):
    assert busy_in(intervals, lo, hi) == pytest.approx(busy)
    assert 0.0 <= idle_share(busy_in(intervals, lo, hi), hi - lo) <= 1.0


@pytest.mark.parametrize("busy,window", [(10.5, 10.0), (-1.0, 10.0),
                                         (0.0, 0.0)])
def test_a_share_outside_0_1_raises(busy, window):
    with pytest.raises(ValueError):
        idle_share(busy, window)


def _trace(offset):
    """A solve's trace: set-up work launched before the loop and still
    running when it starts, a loop of two steps (one host read between),
    then a graph replayed twice after a capture, each replay read back;
    the host's clock runs ``offset`` ahead of the device's."""
    runtime = [(offset + 0.0, 1, "cudaLaunchKernel"),      # set-up
               (offset + 10.0, 2, "cudaLaunchKernel"),     # loop starts
               (offset + 11.0, 3, "cudaLaunchKernel"),
               (offset + 40.0, 4, "cudaMemcpyAsync"),      # host read
               (offset + 41.0, 5, "cudaGraphLaunch"),
               (offset + 60.0, 6, "cudaGraphLaunch"),
               (offset + 61.0, 8, "cudaMemcpyAsync"),      # a block's read
               (offset + 80.0, 7, "cudaLaunchKernel")]     # after the loop
    device = [(1.0, 30.0, 1), (30.0, 35.0, 2), (35.0, 39.0, 3),
              (39.0, 42.0, 4), (45.0, 55.0, 5), (56.0, 58.0, 5),
              (62.0, 70.0, 6), (70.0, 71.0, 8), (81.0, 90.0, 7)]
    return (offset + 10.0, offset + 75.0), runtime, device


@pytest.mark.parametrize("offset", [0.0, 123.5, -7.25])
def test_loop_window_is_on_the_device_clock(offset):
    loop, runtime, device = _trace(offset)
    # the Python driver: from the first activity a call of the loop
    # launched (not the set-up kernel still running) to the last
    lo, hi = loop_window(loop, runtime, device)
    assert (lo, hi) == (30.0, 71.0)
    busy = busy_in([(a, b) for a, b, _ in device], lo, hi)
    assert busy == pytest.approx(12 + 10 + 2 + 9)
    assert idle_share(busy, hi - lo) == pytest.approx(1 - 33 / 41)
    # the graph driver: from its first replay
    lo, hi = loop_window(loop, runtime, device, "cudaGraphLaunch")
    assert (lo, hi) == (45.0, 71.0)
    assert idle_share(busy_in([(a, b) for a, b, _ in device], lo, hi),
                      hi - lo) == pytest.approx(1 - 21 / 26)


def test_graph_window_needs_no_correlation_of_the_graphs_kernels():
    """A graph's kernels may carry correlation ids of no call of this
    loop: its window still starts after the warm-up step's work."""
    loop, runtime, device = _trace(0.0)
    stale = [(a, b, 99 if cid in (5, 6) else cid) for a, b, cid in device]
    assert loop_window(loop, runtime, stale, "cudaGraphLaunch") == (45.0,
                                                                    71.0)


def test_loop_window_without_its_launches_is_none():
    loop, runtime, device = _trace(0.0)
    assert loop_window((100.0, 200.0), runtime, device) is None
    assert loop_window((10.0, 40.0), runtime, device,
                       "cudaGraphLaunch") is None
