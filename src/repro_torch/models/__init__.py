"""The LM scaffold's model families.

  common       layouts (PDef), the model over a layout's tree (`Model`,
               `LayerStack`, `take_layer`), init_params, count_params
  layers       RMSNorm, RoPE, grouped-query, bidirectional and cross
               attention, SwiGLU, embeddings
  transformer  the dense family, and the KV cache, prefill and decode
               loops the MoE family shares
  moe          MoE transformer with SkewShares dispatch and the
               `segment_histogram` kernel's expert loads
  ssm          Mamba2 (chunked SSD, recurrent decode): mamba2-370m
  hybrid       Mamba2 groups with one shared attention block: zamba2-7b
  encdec       encoder-decoder over stub frames: seamless-m4t-medium
  vlm          decoder with gated image cross-attention:
               llama-3.2-vision-90b
  api          the family dispatch
  convert      parameters and AdamW states carried over from the
               reference package
"""
