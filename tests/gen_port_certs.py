"""Writes the port's test-only certificates under
``emqx_tpu_torch/etc/certs/``: a CA, a server certificate (SAN
``127.0.0.1`` and ``localhost``) and a client certificate (CN
``test-client``), EC P-256, valid from 2026-01-01 to 2050-01-01.

They play the role of the reference's ``etc/certs/`` and are for
tests and the chip smoke only: their private keys are public. Run once
where ``cryptography`` is installed; the committed files are what
``chip_smoke.py`` reads (the card's machine may lack ``cryptography``)::

    python3 tests/gen_port_certs.py
"""

from __future__ import annotations

import datetime
import ipaddress
import os

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "emqx_tpu_torch", "etc", "certs")
NOT_BEFORE = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
NOT_AFTER = datetime.datetime(2050, 1, 1, tzinfo=datetime.timezone.utc)


def _name(cn: str) -> x509.Name:
    return x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "emqx_tpu_torch-test"),
        x509.NameAttribute(NameOID.COMMON_NAME, cn),
    ])


def _builder(subject, issuer, key):
    return (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(issuer)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(NOT_BEFORE).not_valid_after(NOT_AFTER))


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca = (_builder(_name("emqx-tpu-torch-test-ca"),
                   _name("emqx-tpu-torch-test-ca"), ca_key)
          .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                         critical=True)
          .sign(ca_key, hashes.SHA256()))
    files = {"cacert.pem": (ca, None)}
    for stem, cn, san in (
            ("", "127.0.0.1", [x509.DNSName("localhost"),
                               x509.IPAddress(
                                   ipaddress.ip_address("127.0.0.1"))]),
            ("client-", "test-client", None)):
        key = ec.generate_private_key(ec.SECP256R1())
        b = _builder(_name(cn), ca.subject, key)
        if san:
            b = b.add_extension(x509.SubjectAlternativeName(san),
                                critical=False)
        files[f"{stem}cert.pem"] = (b.sign(ca_key, hashes.SHA256()), None)
        files[f"{stem}key.pem"] = (None, key)
    for name, (cert, key) in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            if cert is not None:
                f.write(cert.public_bytes(serialization.Encoding.PEM))
            else:
                f.write(key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.TraditionalOpenSSL,
                    serialization.NoEncryption()))
    print(f"wrote {sorted(files)} to {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
