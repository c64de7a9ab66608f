"""repro_torch.calib — activation-aware non-uniform LUT quantization; port
of repro.calib.

msGeMM's LUT machinery takes any 16-entry value codebook at no kernel
cost (the produce basis is a kernel operand, paper §3.2 / Eq. 5); this
package learns those codebooks from a dense model and a small
calibration stream:

    codebook    the Codebook abstraction (uniform int4 = degenerate case)
    stats       per-linear input second moments (observer hook)
    fit         weighted k-means / scale search / GPTQ-lite + calibrate()
    quality     perplexity & logit-MSE harness against the dense model

Typical flow, on the card (``device="cpu"`` on the CPU)::

    result = calib.calibrate(model, cfg, stream, calib.Recipe())
    qcfg   = cfg.replace(quant=result.quant)
    # result.params serves through runtime.serve / serving.Engine
"""

from repro_torch.calib.codebook import Codebook, uniform_values  # noqa: F401
from repro_torch.calib.fit import (  # noqa: F401
    CalibResult, Recipe, calibrate, fit_block_scales, fit_codebook,
    gptq_codes, quantize_slice,
)
from repro_torch.calib.stats import (  # noqa: F401
    StatsCollector, collect, observing,
)
from repro_torch.calib import quality  # noqa: F401
