"""Progress-bar shim (copy of :mod:`bask_tpu.utils.progress`)."""

from __future__ import annotations

__all__ = ["get_progress_bar"]


class _NoOpPBar:
    """Progress-bar interface that does nothing."""

    def __enter__(self, *args, **kwargs):
        return self

    def __exit__(self, *args, **kwargs):
        pass

    def update(self, count):
        pass

    def close(self):
        pass


def get_progress_bar(display, total):
    """A tqdm progress bar when requested and available, else a no-op."""
    if display:
        try:
            import tqdm

            return tqdm.tqdm(total=total)
        except ImportError:
            pass
    return _NoOpPBar()
