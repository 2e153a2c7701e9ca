"""Discrete-event substrate copied from the JAX package (config, events,
requests, memory, metrics, network, traces, expert accounting)."""
