from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes_tpu_torch.ops.demapper import soft_demap, hard_demap, hard_decide
from convolutional_codes_tpu_torch.ops.channels import awgn, bsc, awgn_sigma
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_soft, viterbi_decode_hard
from convolutional_codes_tpu_torch.ops.stack import stack_decode_soft, stack_decode_hard
from convolutional_codes_tpu_torch.ops.fano import fano_decode_soft, fano_decode_hard
from convolutional_codes_tpu_torch.ops.fused_chain import (
    mc_awgn_viterbi, mc_bsc_viterbi, mc_chain_viterbi)

__all__ = ["encode", "map_symbols", "map_symbols_m",
           "soft_demap", "hard_demap", "hard_decide",
           "awgn", "bsc", "awgn_sigma",
           "viterbi_decode_soft", "viterbi_decode_hard",
           "stack_decode_soft", "stack_decode_hard",
           "fano_decode_soft", "fano_decode_hard",
           "mc_chain_viterbi", "mc_awgn_viterbi", "mc_bsc_viterbi"]
