"""http_upload — unbounded chunked uploads and progressive bodies
(reference http_c++ example + ProgressiveReader/ProgressiveAttachment):

- a 5 MiB chunked upload reassembles server-side (stateful dechunking
  across cut windows, far beyond the 64 KiB peek window);
- a progressive route consumes the body WHILE it uploads (the handler
  sees a ProgressiveReader), then streams its response back chunked.

Run:  python -m incubator_brpc_tpu_torch.examples.http_upload
"""

import hashlib
import socket

from incubator_brpc_tpu_torch.rpc import Server


def main() -> None:
    def buffered(frame):  # ordinary route: body arrives complete
        digest = hashlib.sha1(frame.body).hexdigest()
        return 200, "text/plain", f"{len(frame.body)}:{digest}".encode()

    def streaming(frame):  # progressive route: body still arriving
        h = hashlib.sha1()
        n = 0
        while True:
            piece = frame.body.read(timeout=30)
            if not piece:
                break
            h.update(piece)
            n += len(piece)

        def respond():  # progressive response: chunked, unbounded
            yield f"consumed {n} bytes while uploading\n".encode()
            yield f"sha1 {h.hexdigest()}\n".encode()

        return 200, "text/plain", respond()

    server = Server()
    server.add_http_handler("/upload", buffered)
    server.add_http_handler("/stream-upload", streaming, progressive=True)
    assert server.start(0)
    print(f"upload server on 127.0.0.1:{server.port}")

    blob = bytes(range(256)) * 4096 * 5  # 5 MiB
    want = hashlib.sha1(blob).hexdigest()

    def post_chunked(path: str) -> bytes:
        conn = socket.create_connection(("127.0.0.1", server.port), timeout=30)
        conn.sendall(
            f"POST {path} HTTP/1.1\r\nHost: demo\r\n"
            "Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n".encode()
        )
        for i in range(0, len(blob), 100_000):
            c = blob[i : i + 100_000]
            conn.sendall(b"%x\r\n%s\r\n" % (len(c), c))
        conn.sendall(b"0\r\n\r\n")
        out = b""
        while True:
            data = conn.recv(65536)
            if not data:
                break
            out += data
        conn.close()
        return out

    resp = post_chunked("/upload")
    assert f"{len(blob)}:{want}".encode() in resp, resp[:200]
    print(f"buffered upload ok: {len(blob)} bytes, sha1 verified")

    resp = post_chunked("/stream-upload")
    assert f"sha1 {want}".encode() in resp, resp[:200]
    print("progressive upload ok: handler consumed the body mid-flight "
          "and streamed its response")
    server.stop()


if __name__ == "__main__":
    main()
