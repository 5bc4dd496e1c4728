"""builtin — the server's HTTP portal (reference src/brpc/builtin/).

``pages.handle`` routes every HTTP request a server receives: the builtin
pages, then the server's custom handlers, restful mappings and the
``/<service>/<method>`` gateway. The port serves ``/health`` and
``/quitquitquit``; every other builtin page waits for ROADMAP A12.
"""
