"""Quality of service: request classification and the device lanes that
let degraded reads preempt background device work.

* :mod:`.classify`: QoS classes (interactive/standard/background), tenant
  keys, thread-local scope, and X-QoS-Class/X-QoS-Tenant header
  propagation.
* :mod:`.lanes`: foreground/background device lanes for the EC pipeline.

Admission gates, quotas and the shared-memory gate come with the RPC
layer.
"""

from .classify import (BACKGROUND, CLASSES, INTERACTIVE,  # noqa: F401
                       QOS_HEADER, STANDARD, TENANT_HEADER,
                       class_for_tenant, current_class, current_tenant,
                       enabled, from_headers, inject, normalize,
                       qos_scope, retry_after, set_qos)
from .lanes import LANES, DeviceLanes, lanes_enabled  # noqa: F401
