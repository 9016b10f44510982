"""Host-side run-time signals: heartbeat and step timer."""
from .watchdog import Heartbeat, StepTimer  # noqa: F401
