from eabnet_tpu_torch.eval.metrics import (  # noqa: F401
    si_sdr,
    si_sdr_components,
    energy_ratios,
    snr_db,
    hp_filter,
    mean_std,
    mean_conf_int,
    MetricAccumulator,
)
from eabnet_tpu_torch.eval.stoi import stoi  # noqa: F401
from eabnet_tpu_torch.eval.pesq import (  # noqa: F401
    itu_pesq_available,
    pesq,
    pesq_available,
    pesq_backend,
)
from eabnet_tpu_torch.eval.p862 import pesq_p862  # noqa: F401
from eabnet_tpu_torch.eval.harness import (  # noqa: F401
    cal_single_metrics,
    evaluate_dataset,
    write_report,
)
