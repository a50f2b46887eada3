"""emqx_tpu_torch — the PyTorch/CUDA port of the emqx_tpu broker core.

The single-GPU publish → match → dispatch path (the reference's
``emqx_broker:publish/1`` → ``emqx_trie:match/1`` →
``emqx_broker:dispatch/2``): :class:`~emqx_tpu_torch.broker.Broker`
over a :class:`~emqx_tpu_torch.router.Router` whose NFA walk and
bitmap OR run as hand-written CUDA kernels for Hopper
(``csrc/walk.cu``, ``csrc/bitmap_or.cu``); and the retained store
with subscribe-time replay: :class:`~emqx_tpu_torch.node.Node` with
:class:`~emqx_tpu_torch.modules.retainer.RetainerModule`, whose
batched name match runs as kernel B3 (``csrc/retained_match.cu``);
and the MQTT front door: the wire codec (:mod:`emqx_tpu_torch.mqtt`),
the sans-IO :class:`~emqx_tpu_torch.channel.Channel`, the ingress
batcher and a TCP listener (``Node.add_listener``), so a live PUBLISH
or SUBSCRIBE reaches those kernels; and the device mesh
(:mod:`emqx_tpu_torch.parallel`): ``MatcherConfig(mesh=...)`` shards
the filter set and the publish batch over a grid of devices, one B1
walk per cell; and the cluster (:mod:`emqx_tpu_torch.cluster`,
:mod:`emqx_tpu_torch.cluster_net`): route replication puts the whole
cluster's filters in every node's automaton, so the node that takes a
publish matches it on its own device and only deliveries cross nodes.
Every entry point takes ``device=`` (default ``"cuda"``); on CPU
tensors the kernels' plain PyTorch versions run, which is how the
tests hold the port against the JAX package byte for byte.

The package imports torch and numpy only — never JAX, never the JAX
package: the host modules it needs (topic algebra, the trie oracle,
the numpy automaton builder, ...) are its own copies.

Public API mirrors the reference's `emqx` facade (src/emqx.erl:26-64):
subscribe/unsubscribe/publish plus hook management, on a process-default
:class:`~emqx_tpu_torch.broker.Broker` built on first use on the
default device (``"cuda"``). Importing the package loads no torch; the
first call does.
"""

__version__ = "0.1.0"

from emqx_tpu_torch import topic  # noqa: F401

import threading as _threading

_default_broker = None
_default_broker_lock = _threading.Lock()


def default_broker():
    """The process-default Broker, created on first use (the role of
    the running `emqx` application) on the default device, ``"cuda"``:
    without CUDA the first call raises. Heavy imports (torch) happen
    here, not at package import. A CPU caller installs its own broker
    as ``emqx_tpu_torch._default_broker``."""
    global _default_broker
    if _default_broker is None:
        with _default_broker_lock:
            if _default_broker is None:  # double-checked: two racing
                # first calls must not each build a Broker and strand
                # one thread's subscriptions on the losing instance
                from emqx_tpu_torch.broker import Broker
                _default_broker = Broker()
    return _default_broker


def subscribe(sub, topic_filter: str, opts=None):
    """emqx:subscribe (src/emqx.erl:26-64): ``sub`` needs a
    ``deliver(topic_filter, msg)`` method."""
    return default_broker().subscribe(sub, topic_filter, opts)


def unsubscribe(sub, topic_filter: str) -> bool:
    return default_broker().unsubscribe(sub, topic_filter)


def publish(msg) -> int:
    """emqx:publish — ``msg`` is an :class:`emqx_tpu_torch.types.Message`;
    returns the local delivery count."""
    return default_broker().publish(msg)


def hook(name: str, fn, priority: int = 0):
    """emqx:hook — register on a hookpoint chain."""
    return default_broker().hooks.add(name, fn, priority=priority)


def unhook(name: str, fn) -> None:
    default_broker().hooks.delete(name, fn)


__all__ = ["topic", "default_broker", "subscribe",
           "unsubscribe", "publish",
           "hook", "unhook", "__version__"]
