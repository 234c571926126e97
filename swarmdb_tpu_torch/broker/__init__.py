"""Message broker interface and the in-process LocalBroker."""
