"""64-bit integer hash used for alignment tie-breaking (utils.h:117-128)."""

MASK64 = (1 << 64) - 1


def hash_64(key: int) -> int:
    key &= MASK64
    key = (key + (~(key << 32) & MASK64)) & MASK64
    key ^= key >> 22
    key = (key + (~(key << 13) & MASK64)) & MASK64
    key ^= key >> 8
    key = (key + (key << 3)) & MASK64
    key ^= key >> 15
    key = (key + (~(key << 27) & MASK64)) & MASK64
    key ^= key >> 31
    return key
