"""Failure handling around training: the non-finite step guard, fault
injection, durable artifacts and the preemption guard."""
