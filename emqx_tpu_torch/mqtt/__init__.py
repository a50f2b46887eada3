"""MQTT v3.1/v3.1.1/v5.0 wire protocol: packets, codec, properties,
reason codes (reference: src/emqx_frame.erl, emqx_packet.erl,
emqx_mqtt_props.erl, emqx_reason_codes.erl)."""
