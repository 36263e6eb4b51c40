"""Control-plane pieces the port's round path publishes on and consults:
the event bus (``events``), the §5.6 revocation model (``revocation``)
and the §4.4 straggler policy (``control_plane``)."""
