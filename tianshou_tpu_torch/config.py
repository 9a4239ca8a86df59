"""Global flags (reference tianshou/config.py:1 ``ENABLE_VALIDATION``).

``ENABLE_VALIDATION`` gates optional integrity checks (NaN detection in
collected batches) that cost host syncs when on.
"""

ENABLE_VALIDATION = False
