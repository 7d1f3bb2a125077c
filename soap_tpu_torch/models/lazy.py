"""Trace-time memoizing property — the analogue of the reference's
``SOAP/core/lazy_properties.py:16-59``, shared by the property mixins."""

from __future__ import annotations


class lazy_property:
    """Memoizes on the instance __dict__, so a shared intermediate of
    the property DAG is computed once per slice."""

    def __init__(self, fn):
        self.fn = fn
        self.name = fn.__name__
        self.__doc__ = fn.__doc__

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        value = self.fn(obj)
        obj.__dict__[self.name] = value
        return value
