"""Streaming orchestration: frame segmentation, timing, session lifecycle."""

from xmaps.runtime.trigger_finder import RobustTriggerFinder  # noqa: F401
from xmaps.runtime.watchdog import TimingWatchdog  # noqa: F401
from xmaps.runtime.pipe import DepthReprojectionPipe  # noqa: F401
from xmaps.runtime.processor import (  # noqa: F401
    DepthReprojectionProcessor,
    FakeWindow,
)
