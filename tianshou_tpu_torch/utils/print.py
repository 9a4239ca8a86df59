"""Pretty-print mixin for config and stats dataclasses (a copy of
``tianshou_tpu/utils/print.py``; reference utils/print.py:7
``DataclassPPrintMixin``)."""

from __future__ import annotations

import pprint
from collections.abc import Sequence
from dataclasses import asdict, is_dataclass

__all__ = ["DataclassPPrintMixin"]


class DataclassPPrintMixin:
    def pprints_asdict(self, exclude_fields: Sequence[str] | None = None, indent: int = 4) -> str:
        """Pretty string of the dataclass as a dict, minus ``exclude_fields``."""
        prefix = f"{self.__class__.__name__}\n" + "-" * 40 + "\n"
        d = asdict(self) if is_dataclass(self) else dict(vars(self))
        for field in exclude_fields or []:
            d.pop(field, None)
        return prefix + pprint.pformat(d, indent=indent)

    def pprint_asdict(self, exclude_fields: Sequence[str] | None = None, indent: int = 4) -> None:
        print(self.pprints_asdict(exclude_fields=exclude_fields, indent=indent))
