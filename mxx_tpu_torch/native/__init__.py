"""Host native code of the port: the bit-packing codec and the asynchronous
artifact writer, C++ under `csrc/host/` built with g++ at first use."""

from .codec import pack_u32, packed_size, unpack_u32  # noqa: F401
