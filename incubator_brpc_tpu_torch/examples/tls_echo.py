"""tls_echo — encrypted echo (reference example/http_c++ ssl options /
ChannelOptions.ssl_options): the server encrypts every accepted
connection; the client verifies the server certificate. A throwaway
key/cert pair is generated at run time with the ``openssl`` binary, so no
private key sits next to the example code.

Run:  python -m incubator_brpc_tpu_torch.examples.tls_echo

The port's copy of the JAX package's ``examples/tls_echo.py``.
"""

import ssl
import subprocess
import tempfile

from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions


def make_throwaway_cert(tmpdir: str) -> tuple:
    """A self-signed localhost certificate valid for one day, in a temp dir."""
    cert, key = f"{tmpdir}/cert.pem", f"{tmpdir}/key.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert, "-days", "1", "-nodes",
            "-subj", "/CN=localhost",
        ],
        check=True,
        capture_output=True,
    )
    return cert, key


def main() -> None:
    tmp = tempfile.TemporaryDirectory(prefix="tls_echo_")
    cert, key = make_throwaway_cert(tmp.name)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert, key)
    server = Server(ServerOptions(ssl_context=server_ctx))
    server.add_service("EchoService", {"Echo": lambda cntl, req: req})
    assert server.start(0)
    print(f"TLS EchoServer on 127.0.0.1:{server.port}")

    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.load_verify_locations(cert)
    client_ctx.check_hostname = False  # the demo cert is CN=localhost, the target the IP
    client_ctx.verify_mode = ssl.CERT_REQUIRED
    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}", options=ChannelOptions(ssl_context=client_ctx))
    cntl = ch.call_method("EchoService", "Echo", b"over-tls")
    assert cntl.ok(), cntl.error_text
    print(f"response={cntl.response_payload!r} (cipher negotiated, cert verified)")
    server.stop()
    server.join(timeout=10)
    tmp.cleanup()  # remove the throwaway key material promptly


if __name__ == "__main__":
    main()
