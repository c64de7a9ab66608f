from repro_torch.quant.quantize import (  # noqa: F401
    QUANTIZABLE, quantize_model, quantized_size_bytes,
)
