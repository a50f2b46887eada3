"""Small copies of the cells' configuration and traffic for CPU runs."""

from benchmark import manifest, workload


def plus_cfg() -> dict:
    cfg = workload.load(manifest.config_path("plus_1m"))
    cfg["classes"][0]["count"] = 3000
    cfg["node"]["batch_size"] = 256
    return cfg


def hash_cfg() -> dict:
    cfg = workload.load(manifest.config_path("hash_1m_deep"))
    cfg["classes"][0]["count"] = 3000
    cfg["node"]["batch_size"] = 256
    return cfg


def mixed_cfg() -> dict:
    """Every filter kind the generator knows, on ``plus_1m``'s tree:
    literal, ``#``, ``$share`` groups and wide filters above the
    fan-out threshold (the bitmap path) beside the ``+`` filters."""
    cfg = plus_cfg()
    cfg["classes"] += [
        {"name": "literal", "kind": "literal", "count": 200},
        {"name": "hash", "kind": "hash", "count": 200, "depth_min": 4,
         "depth_max": 4},
        {"name": "shared", "kind": "plus", "count": 50, "share": "g",
         "members": 4},
        {"name": "wide", "kind": "wide", "count": 2, "members": 1100,
         "members_from": "plus"}]
    cfg["draw"] = ["plus", "literal", "hash", "shared"]
    cfg["draw_insert"] = [{"class": "wide", "rank": 100}]
    return cfg


def traffic(name: str) -> dict:
    tr = workload.load(manifest.traffic_path(name))
    tr.update(publishers=64, inflight=4, warmup_msgs=512,
              prefill_per_s=2000, check_sample=400)
    return tr
