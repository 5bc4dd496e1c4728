"""utils — the endpoint, status codes, flags and the device probe."""

from incubator_brpc_tpu_torch.utils.device import resolve_device
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import define_flag, flag_registry, get_flag, set_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode, Status, berror

__all__ = [
    "EndPoint",
    "str2endpoint",
    "ErrorCode",
    "Status",
    "berror",
    "define_flag",
    "get_flag",
    "set_flag",
    "flag_registry",
    "resolve_device",
]
