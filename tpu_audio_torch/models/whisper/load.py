"""Whisper serving trees (port of tpu_audio/models/whisper/load.py:
serve_tree_int8).

Checkpoint loading (`load`, `sanitize`, the safetensors key remap) is not
ported yet (ROADMAP A7); trees come from `model.init_params` or from
`convert.params_from_numpy`.
"""

from __future__ import annotations

from tpu_audio_torch.ops import quant


def serve_tree_int8(tree: dict, decoder: bool = True,
                    encoder: bool = True) -> dict:
    """Per-channel int8 W8A8 serving tree: the block matmul weights of the
    chosen halves, and the decoder's tied token embedding, become
    {"weight_i8", "scale_i8"} dicts; convs, norms, biases and positions
    stay as they are. Stacked (L, O, I) leaves keep the JAX layout.

    `Whisper` runs both halves: an int8 decoder through the int8 matmul
    kernels, an int8 encoder (`encoder=True`, the full w8a8 tree) through
    the W8A8 encoder-block kernels (`ops/kernels/fused_encoder_int8.py`)."""
    out = {**tree}
    if encoder:
        enc = quant.requantize_tree_int8(tree["encoder"], fuse=False)
        out["encoder"] = quant.quantize_tree_int8(
            enc, predicate=lambda k, v: "blocks" in k)
    if decoder:
        dec = quant.requantize_tree_int8(tree["decoder"], fuse=False)
        out["decoder"] = quant.quantize_tree_int8(
            dec, predicate=lambda k, v: "blocks" in k
            or k == "token_embedding.weight")
    return out
