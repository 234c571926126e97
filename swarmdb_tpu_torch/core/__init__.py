"""Messages and the SwarmDB runtime."""
