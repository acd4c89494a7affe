"""The Pulsar transport (import-gated).

Counterpart of ``attendance_tpu/transport/pulsar_client.py``: a thin
adapter with the memory broker's call shapes over pulsar-client, used
only with ``--transport-backend pulsar``, so the port runs where
pulsar-client is not installed. It keeps the reference's usage: a Shared
subscription, ack and nack per message (reference
attendance_processor.py:29-34, 101, 132, 136).

The client keeps pulsar-client's per-message surface: its consumers have
``receive``, ``acknowledge``, ``negative_acknowledge`` and ``close`` and
none of the memory broker's batch calls, and its messages give
``data()``, ``properties()``, ``message_id()`` and
``redelivery_count()`` as methods. The port's consumers detect the batch
calls and take their per-message paths without them
(``transport.collect_batch``, ``acknowledge_all``, ``message_id``). One
thing is wrapped: pulsar-client raises its own ``Timeout`` from
``receive``, where every run loop of the port ends a quiet round on the
transport's :class:`ReceiveTimeout`.
"""

from __future__ import annotations

from attendance_tpu_torch.transport.memory_broker import ReceiveTimeout


class PulsarConsumer:
    """A pulsar-client ``Consumer`` whose ``receive`` raises
    :class:`ReceiveTimeout` where pulsar raises its ``Timeout``; every
    other attribute is the consumer's own."""

    def __init__(self, consumer, timeout_exc):
        self._consumer = consumer
        self._timeout_exc = timeout_exc

    def receive(self, timeout_millis=None):
        try:
            return self._consumer.receive(timeout_millis=timeout_millis)
        except self._timeout_exc as exc:
            raise ReceiveTimeout(
                f"no message within {timeout_millis}ms") from exc

    def __getattr__(self, name):
        return getattr(self._consumer, name)


class PulsarClient:
    def __init__(self, service_url: str):
        try:
            import pulsar
        except ImportError:
            raise RuntimeError(
                "transport_backend='pulsar' requires the pulsar-client "
                "package") from None
        self._pulsar = pulsar
        self._client = pulsar.Client(service_url)

    def create_producer(self, topic: str):
        return self._client.create_producer(topic)

    def subscribe(self, topic: str, subscription_name: str,
                  consumer_type=None):
        if consumer_type is None:
            consumer_type = self._pulsar.ConsumerType.Shared
        return PulsarConsumer(
            self._client.subscribe(topic, subscription_name,
                                   consumer_type=consumer_type),
            self._pulsar.Timeout)

    def close(self) -> None:
        self._client.close()
