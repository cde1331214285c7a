"""Program families of the deployments, one module each, named by a
configuration's ``program.kind``: each builds the program source from
the reference's frozen generators and hands the same source to the port
and to the reference."""
