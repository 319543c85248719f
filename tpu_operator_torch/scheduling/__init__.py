"""Fair-share admission over the placement plane (Gavel-style policies):
the port's counterpart of ``tpu_operator/scheduling/``."""

from .quota import (  # noqa: F401
    ADMISSION_GATE,
    DEFAULT_CLASS,
    POLICIES,
    POLICY_BASELINE,
    AdmissionState,
    QuotaClass,
    QuotaTree,
    baseline_key,
    env_admission_policy,
    order_batch,
    quota_report,
)
