"""Native (C++) host-side components.

The reference's only native first-party obligation is the LD06 sensor-ingest
path (SURVEY.md §2.3); `ld06` provides it: a C++ stream parser/filter/
assembler built on demand with g++, a ctypes binding, and an LD06 packet
*encoder* so the simulator can exercise the real wire format end-to-end.
"""

from jax_mapping_torch.native.ld06 import (  # noqa: F401
    Ld06Parser, encode_packets, native_available,
)
