"""The window's arithmetic on a fake clock, and the tail statistic."""

from portbench import common


def test_window_opens_after_warmup_and_closes_past_the_seconds():
    win = common.Window(seconds=2.0, warm=20)
    clock = [0.0]
    closed_at = None
    for unit in range(10, 400, 10):  # a report every 10 steps of 0.1 s
        clock[0] += 1.0
        if win.tick(unit, clock[0]):
            closed_at = unit
            break
    assert (win.u_open, win.t_open) == (20, 2.0)
    # the first report 2 s or more after the open closes it
    assert (closed_at, win.t_close, win.units) == (40, 4.0, 20)
    assert win.ms_per_unit() == 100.0
    assert not win.is_open


def test_window_rate_counts_all_time():
    win = common.Window(seconds=1.0, warm=0)
    win.tick(0, 10.0)
    assert not win.tick(5, 10.4)  # a slow stretch stays in the rate
    assert win.tick(10, 13.0)
    assert win.ms_per_unit() == 300.0


def test_a_held_window_stays_open_up_to_its_limit():
    win = common.Window(seconds=1.0, warm=0, hold_limit=3.0)
    win.tick(0, 0.0)
    assert not win.tick(10, 1.5, hold=True)  # held past the seconds
    assert not win.tick(20, 2.9, hold=True)
    assert win.tick(30, 3.0, hold=True)  # the limit closes a held window
    assert (win.units, win.t_close) == (30, 3.0)
    assert not win.tick(40, 9.0)  # a closed window takes no more reports


def test_a_viewer_window_counts_frames_a_second():
    """Ticked once a frame: frames over all the window's seconds."""
    win = common.Window(seconds=2.0, warm=5)
    clock = 0.0
    for frame in range(1, 100):
        clock += 0.25 if frame != 8 else 1.0  # one slow frame stays in the rate
        if win.tick(frame, clock):
            break
    assert (win.u_open, win.t_open) == (5, 1.25)
    assert (win.u_close, win.t_close) == (10, 3.25)
    assert win.units_per_s() == 5 / 2.0


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert common.percentile(xs, 95) == 95
    assert common.percentile(xs, 50) == 50
    assert common.percentile([7.0], 95) == 7.0
    assert common.percentile([3, 1, 2], 100) == 3
