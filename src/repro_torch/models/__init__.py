"""The LM scaffold's model families (so far the dense and MoE transformers).

  common       layouts (PDef), the model over a layout's tree (`Model`,
               `LayerStack`, `take_layer`), init_params, count_params
  layers       RMSNorm, RoPE, grouped-query attention, SwiGLU, embeddings
  transformer  the dense family, and the KV cache, prefill and decode
               loops the MoE family shares
  moe          MoE transformer with SkewShares dispatch and the
               `segment_histogram` kernel's expert loads
  api          the family dispatch
  convert      parameters and AdamW states carried over from the
               reference package
"""
