"""Observability facade + bias handling (reference: stats_printer.py,
biases.py)."""

import time

import numpy as np
import pytest

from xmaps.io.biases import Biases, load_bias_file
from xmaps.utils.stats import SingleTimer, StatsPrinter


def test_stats_counters_metrics_timers(capsys):
    sp = StatsPrinter(silent=True)
    for _ in range(3):
        sp.count("processed evs", 100)
    sp.add_metric("frame len [ms]", 14.2)
    sp.add_metric("frame len [ms]", 15.8)
    with sp.measure_time("main loop"):
        pass
    sp.print_stats()
    # silent mode swallows the dashboard but aggregation must not error
    sp.toggle_silence()
    sp.count("frames shown")
    sp.log("hello")
    sp.print_stats()
    out = capsys.readouterr().out
    assert "hello" in out
    assert "frames shown" in out


def test_single_timer_prints_duration(capsys):
    with SingleTimer("Setting up test"):
        time.sleep(0.01)
    out = capsys.readouterr().out
    assert "Setting up test" in out
    assert "done in" in out


def test_load_bias_file(tmp_path):
    p = tmp_path / "cam.bias"
    p.write_text("300 % bias_diff\n375  %  bias_diff_on\n\n")
    b = load_bias_file(str(p))
    assert b == {"bias_diff": 300, "bias_diff_on": 375}


def test_biases_cycle_and_limits():
    b = Biases()
    first = b.current_bias
    names = {b.cycle_current_bias() for _ in range(len(b.biases))}
    assert first in names and len(names) == len(b.biases)
    # increase/decrease respect the per-bias limits (reference biases.py)
    for _ in range(10000):
        b.increase_current(100)
    lo, hi = b.biases_limits[b.current_bias]
    assert b.biases[b.current_bias] <= hi
    for _ in range(10000):
        b.decrease_current(100)
    assert b.biases[b.current_bias] >= lo
