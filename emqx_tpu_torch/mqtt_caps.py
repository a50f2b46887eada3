"""Per-zone MQTT capability checks.

Mirrors ``src/emqx_mqtt_caps.erl`` (check_pub/2, check_sub/3,
get_caps/1): a publish or subscribe is vetted against the listener
zone's advertised limits before it touches the session/broker. The
checks return an MQTT v5 reason code on violation, ``None`` when the
operation is within caps.
"""

from __future__ import annotations

from typing import Dict, Optional

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.mqtt import reason_codes as RC
from emqx_tpu_torch.zone import Zone

# check_pub codes that count as a dropped publish (vs a malformed one)
PUB_DROP_CODES = frozenset({RC.QOS_NOT_SUPPORTED, RC.RETAIN_NOT_SUPPORTED})


def check_pub(zone: Zone, qos: int, retain: bool,
              topic: str) -> Optional[int]:
    """Vet a PUBLISH against zone caps (emqx_mqtt_caps:check_pub/2)."""
    if qos > zone.max_qos_allowed:
        return RC.QOS_NOT_SUPPORTED
    if retain and not zone.retain_available:
        return RC.RETAIN_NOT_SUPPORTED
    if zone.max_topic_levels and T.levels(topic) > zone.max_topic_levels:
        return RC.TOPIC_NAME_INVALID
    return None


def check_sub(zone: Zone, bare: str,
              popts: Dict[str, str]) -> Optional[int]:
    """Vet one SUBSCRIBE filter against zone caps
    (emqx_mqtt_caps:check_sub/3). ``bare`` is the filter with any
    ``$share/<group>/`` prefix stripped; ``popts`` carries the parsed
    share group if present."""
    if "share" in popts and not zone.shared_subscription:
        return RC.SHARED_SUBSCRIPTIONS_NOT_SUPPORTED
    if T.wildcard(bare) and not zone.wildcard_subscription:
        return RC.WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED
    if zone.max_topic_levels and T.levels(bare) > zone.max_topic_levels:
        return RC.TOPIC_FILTER_INVALID
    return None

