"""Shared constants: base encoding, Phred conventions, padding sentinels.

Base encoding is 2-bit-friendly: A=0 C=1 G=2 T=3; N=4 carries no
evidence; PAD=5 marks cycles beyond a read's length or slots beyond a
batch's fill. All quality scores are Phred (integer, u8), error
probability e = 10**(-q/10).
"""

BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
BASE_N = 4
BASE_PAD = 5

N_REAL_BASES = 4

BASE_CHARS = "ACGTN."
CHAR_TO_CODE = {c: i for i, c in enumerate(BASE_CHARS)}

# Phred caps. 93 is the largest printable SAM quality ('~' - '!').
MAX_PHRED = 93
NO_CALL_QUAL = 2  # quality emitted for an N consensus call
MIN_ERROR_PROB = 1e-10  # floor when converting quality -> error prob

# Sentinel family/molecule id for reads that belong to no family
# (padding slots, filtered reads).
NO_FAMILY = -1
