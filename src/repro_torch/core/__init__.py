"""Control-plane pieces the port's round path publishes on."""
