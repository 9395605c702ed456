"""GGUF / ggml constants.

Capability parity with the GGUF binary format implemented in the reference at
llama.cpp-b2430/ggml.c:20500-21300 and gguf-py/gguf/constants.py. Values are
part of the on-disk format and therefore identical by necessity.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGMLType(enum.IntEnum):
    """ggml tensor data types (subset we support + placeholders for ids)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3, removed upstream
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_elems, block_size_bytes) — ggml-common.h:144-224,316-320
GGML_TYPE_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.Q4_0: (32, 18),   # fp16 d + 16B nibbles
    GGMLType.Q4_1: (32, 20),   # fp16 d,m + 16B nibbles
    GGMLType.Q5_0: (32, 22),   # fp16 d + 4B qh + 16B nibbles
    GGMLType.Q5_1: (32, 24),   # fp16 d,m + 4B qh + 16B nibbles
    GGMLType.Q8_0: (32, 34),   # fp16 d + 32 int8
    GGMLType.Q8_1: (32, 36),   # fp16 d,s + 32 int8
    GGMLType.Q2_K: (256, 84),  # 16B scales + 64B crumbs + fp16 d,dmin
    GGMLType.Q8_K: (256, 292),  # f32 d + 256 int8 + 16 i16 bsums
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.F64: (1, 8),
}


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# llama_ftype (llama.h) — model-level file type ids, stored as general.file_type
class LlamaFtype(enum.IntEnum):
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10


FTYPE_TO_GGML = {
    LlamaFtype.ALL_F32: GGMLType.F32,
    LlamaFtype.MOSTLY_F16: GGMLType.F16,
    LlamaFtype.MOSTLY_Q4_0: GGMLType.Q4_0,
    LlamaFtype.MOSTLY_Q4_1: GGMLType.Q4_1,
    LlamaFtype.MOSTLY_Q8_0: GGMLType.Q8_0,
    LlamaFtype.MOSTLY_Q5_0: GGMLType.Q5_0,
    LlamaFtype.MOSTLY_Q5_1: GGMLType.Q5_1,
    LlamaFtype.MOSTLY_Q2_K: GGMLType.Q2_K,
}


def type_row_bytes(ggml_type: GGMLType, n_elems: int) -> int:
    """Bytes for a contiguous run of n_elems of this type (ggml nrow logic)."""
    bs, tb = GGML_TYPE_SIZES[ggml_type]
    if n_elems % bs != 0:
        raise ValueError(f"{n_elems} not a multiple of block size {bs} for {ggml_type!r}")
    return n_elems // bs * tb
