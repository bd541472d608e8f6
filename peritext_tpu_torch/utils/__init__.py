"""Host-side helpers: string interning and device selection."""

from .device import resolve_device
from .interning import Interner, OrderedActorTable, content_hash32

__all__ = ["Interner", "OrderedActorTable", "content_hash32", "resolve_device"]
