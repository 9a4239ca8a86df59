"""Progress display (a copy of ``tianshou_tpu/utils/progress.py``; reference
utils/progress_bar.py and the tqdm bars in trainer.py:420): a thin tqdm
wrapper that is a no-op when ``show_progress`` is off or tqdm is missing.
tqdm is imported only when a bar is made."""

from __future__ import annotations

__all__ = ["progress_bar"]


class _Noop:
    def update(self, n: int = 1) -> None: ...
    def set_postfix(self, **kw) -> None: ...
    def close(self) -> None: ...

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def progress_bar(total: int, desc: str, enabled: bool):
    if not enabled:
        return _Noop()
    try:
        from tqdm import tqdm
    except ImportError:
        return _Noop()
    return tqdm(total=total, desc=desc, unit="step", dynamic_ncols=True)
