"""Core MPI objects: ops, datatypes, groups, communicators — mirroring
``ompi/{op,datatype,group,communicator}``."""
