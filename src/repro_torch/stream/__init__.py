"""Update log, snapshots, maintenance and the GraphService facade."""
