"""Wire-format tags: which decoder a stream belongs to.

Copy of ``icm_tpu/coding/wire.py``. The host wire is untagged rANS
bytes. The device wire (``models/device_codec.py``) and the JAX package's
scan wire lead with ``WIRE_MAGIC + format byte``. A stream fed to the
wrong decoder would decode to garbage, so each decoder checks:
:func:`wire_offset` demands the device tag, and the host decoder
recognises a tagged stream (magic, format and an exact payload-length
equation) with :func:`reject_framework_wire`. Both raise
:class:`WireFormatError`.
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


def wire_offset(blob, expect: int) -> int:
    """Check the 4-byte tag; -> offset of the first payload byte."""
    head = bytes(blob[:4])
    if head[:3] != WIRE_MAGIC:
        raise WireFormatError(
            f"not a framework {WIRE_NAMES[expect]} stream (no wire magic; "
            f"leading bytes {head!r}). Host/reference rANS streams are "
            "untagged: decode those with the host-wire codec."
        )
    if head[3] != expect:
        found = WIRE_NAMES.get(head[3], f"unknown 0x{head[3]:02x}")
        raise WireFormatError(
            f"wire format mismatch: stream is {found}, decoder expects "
            f"{WIRE_NAMES[expect]}. Scan-wire and unrolled-protocol streams "
            "reduce the AR context in different float orders and are not "
            "interchangeable."
        )
    return 4


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
