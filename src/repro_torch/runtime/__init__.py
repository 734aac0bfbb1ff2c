"""Fault tolerance for the port (counterpart of repro/runtime): the step
supervisor the serving engine runs its decode tick under."""
