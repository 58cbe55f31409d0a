"""Guard objects for optional dependencies.

A :class:`TripWire` stands in for a module (or any object) that could not be
imported.  Any attribute access or call raises :class:`TripWireError` with the
message supplied at construction time, so the failure happens lazily at first
use rather than at import time.

A copy of ``microstructure_fingerprinting_tpu/tripwire.py``, which
mirrors the upstream microstructure_fingerprinting/tripwire.py, itself
DIPY's optional-dependency pattern.
"""


class TripWireError(AttributeError):
    """Raised on first use of a :class:`TripWire` placeholder object."""


def is_tripwire(obj):
    """Return True if ``obj`` behaves like a :class:`TripWire` placeholder."""
    try:
        obj.any_attribute
    except TripWireError:
        return True
    except Exception:
        pass
    return False


class TripWire(object):
    """Placeholder that raises :class:`TripWireError` when touched.

    Examples
    --------
    >>> try:
    ...     import not_a_real_module
    ... except ImportError:
    ...     not_a_real_module = TripWire('not_a_real_module is unavailable')
    """

    def __init__(self, msg):
        self._msg = msg

    def __getattr__(self, attr_name):
        raise TripWireError(self._msg)

    def __call__(self, *args, **kwargs):
        raise TripWireError(self._msg)
