"""Error base — JAX equivalent of the reference's ``edm_error``
(reference lib/edm.cpp:4-7 prints ``[EDM:location] msg`` and aborts).

Host-side configuration errors raise ``EDMError``; in-jit invariants use
masks/flags checked by the host (aborting inside a compiled device program is
not possible, and is a design smell anyway).
"""

from __future__ import annotations


class EDMError(RuntimeError):
    def __init__(self, msg: str, location: str = ""):
        super().__init__(f"[EDM:{location}] {msg}" if location else f"[EDM] {msg}")
        self.location = location


def edm_error(msg: str, location: str = "") -> None:
    raise EDMError(msg, location)
