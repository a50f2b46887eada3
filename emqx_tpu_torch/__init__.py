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
walk per cell.
Every entry point takes ``device=`` (default ``"cuda"``); on CPU
tensors the kernels' plain PyTorch versions run, which is how the
tests hold the port against the JAX package byte for byte.

The package imports torch and numpy only — never JAX, never the JAX
package: the host modules it needs (topic algebra, the trie oracle,
the numpy automaton builder, ...) are its own copies.
"""

__version__ = "0.1.0"
