"""Wire-format tags: the host decoder's guard against tagged streams.

Copy of the tag check in ``icm_tpu/coding/wire.py``. The host wire is
untagged rANS bytes. The JAX package's device and scan wires lead with
``WIRE_MAGIC + format byte``; such a stream fed to the host decoder would
decode to garbage, so the decoder recognises one (magic, format and an
exact payload-length equation) and raises :class:`WireFormatError`.
"""

from __future__ import annotations

import struct

WIRE_MAGIC = b"\x93IW"  # 3-byte framework-wire magic
WIRE_DEVICE = 0xD2  # unrolled-protocol device-v2 streams
WIRE_SCAN = 0x5C  # scan-wire streams (a tier byte follows the format)
WIRE_NAMES = {
    WIRE_DEVICE: "device-v2 (unrolled protocol)",
    WIRE_SCAN: "scan-wire",
}


class WireFormatError(ValueError):
    """A bitstream was fed to a decoder of a different wire format."""


def looks_like_framework_wire(blob):
    """Format byte if ``blob`` parses exactly as a tagged wire, else None."""
    if bytes(blob[:3]) != WIRE_MAGIC or len(blob) < 16:
        return None
    fmt = blob[3]
    if fmt not in WIRE_NAMES:
        return None
    o = 5 if fmt == WIRE_SCAN else 4
    if len(blob) < o + 12:
        return None
    n_lanes, n_words, n_esc = struct.unpack_from("<III", blob, o)
    if len(blob) == o + 12 + 2 * n_lanes + 2 * n_words + 8 * n_esc:
        return fmt
    return None


def reject_framework_wire(blob, transport: str = "host") -> None:
    """Raise when a tagged device/scan stream reaches the host coder."""
    fmt = looks_like_framework_wire(blob)
    if fmt is not None:
        raise WireFormatError(
            f"stream is a framework {WIRE_NAMES[fmt]} stream but the "
            f"{transport} coder expects untagged host/reference rANS "
            "bytes — decode it with the codec wire it was encoded under."
        )
