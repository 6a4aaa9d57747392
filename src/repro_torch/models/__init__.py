"""The LM scaffold's model families (so far the MoE transformer).

  common       layouts (PDef), ParamTree, init_params, count_params
  layers       RMSNorm, RoPE, grouped-query attention, embeddings
  transformer  the KV cache the MoE family shares
  moe          MoE transformer with SkewShares dispatch and the
               `segment_histogram` kernel's expert loads
  api          the family dispatch
  convert      parameters carried over from the reference package
"""
