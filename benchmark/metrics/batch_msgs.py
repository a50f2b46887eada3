"""batch_msgs: messages a device batch of the ingress batcher held in the
window (``IngressBatcher.device_msgs / device_batches``)."""


def read(run):
    n = run.delta("ingress.device_batches")
    if n <= 0:
        return None
    return run.delta("ingress.device_msgs") / n
