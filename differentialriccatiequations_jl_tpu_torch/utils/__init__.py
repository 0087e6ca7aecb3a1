"""Problem generators (`testmat`), solver callbacks (`Observer`, `notify`)
and the host timers (`timers`)."""

from .callbacks import Observer, notify
from . import timers

__all__ = ["Observer", "notify", "timers"]
