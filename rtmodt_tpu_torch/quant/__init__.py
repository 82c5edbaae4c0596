from rtmodt_tpu_torch.quant.ptq import (  # noqa: F401
    QuantConv,
    QuantizedConvBN,
    apply_quant,
    collect_act_scales,
    load_act_scales,
    quantize_convs,
    quantize_model,
    quantize_with_scales,
)
