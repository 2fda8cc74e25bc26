"""An offline queue served in a closed loop: each forward takes
`traffic.batch` scenes from the queue, and the next forward starts once
their renders are back on the host. It is serve_closed's request, check
and records with a batch of many scenes; the cell reports
`scenes_per_s`."""

from .serve_closed import readings, run  # noqa: F401
