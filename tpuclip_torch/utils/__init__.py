from tpuclip_torch.utils.logging import log, safe_print_path  # noqa: F401
from tpuclip_torch.utils.profiling import StepTimers, Timings  # noqa: F401
