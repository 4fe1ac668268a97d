/* CRC-32C (Castagnoli) for the serving wire's frame and ring checksums.
 *
 * Host code, not a device kernel: the reflected polynomial 0x82F63B78 with
 * init and xorout 0xFFFFFFFF (the iSCSI / ext4 variant), computed slice by
 * 8 over eight 256-entry tables. Portable C99: bytes are assembled into
 * words one by one, so the result does not depend on the host's byte
 * order or alignment rules, and no instruction set extension is assumed.
 *
 * Streaming: dml_crc32c_update(crc, p, n) takes the finished CRC of the
 * bytes before p (0 for none) and returns the finished CRC of those bytes
 * followed by p[0..n), so update(update(0, a), b) == crc(a || b).
 * dml_crc32c_init() fills the tables; the loader calls it once, before
 * any update.
 */

#include <stddef.h>
#include <stdint.h>

#define DML_CRC32C_POLY 0x82F63B78u

static uint32_t table[8][256];

void dml_crc32c_init(void)
{
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int j = 0; j < 8; ++j)
            c = (c & 1u) ? (c >> 1) ^ DML_CRC32C_POLY : c >> 1;
        table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
        for (int k = 1; k < 8; ++k)
            table[k][i] = (table[k - 1][i] >> 8)
                          ^ table[0][table[k - 1][i] & 0xFFu];
}

static uint32_t load_le32(const unsigned char *p)
{
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
           | ((uint32_t)p[3] << 24);
}

uint32_t dml_crc32c_update(uint32_t crc, const void *data, size_t n)
{
    const unsigned char *p = (const unsigned char *)data;
    uint32_t c = crc ^ 0xFFFFFFFFu;
    /* bytes one at a time up to an 8-byte boundary of the address */
    while (n > 0 && ((uintptr_t)p & 7u) != 0) {
        c = table[0][(c ^ *p++) & 0xFFu] ^ (c >> 8);
        --n;
    }
    while (n >= 8) {
        uint32_t lo = c ^ load_le32(p);
        uint32_t hi = load_le32(p + 4);
        c = table[7][lo & 0xFFu] ^ table[6][(lo >> 8) & 0xFFu]
            ^ table[5][(lo >> 16) & 0xFFu] ^ table[4][lo >> 24]
            ^ table[3][hi & 0xFFu] ^ table[2][(hi >> 8) & 0xFFu]
            ^ table[1][(hi >> 16) & 0xFFu] ^ table[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n > 0) {
        c = table[0][(c ^ *p++) & 0xFFu] ^ (c >> 8);
        --n;
    }
    return c ^ 0xFFFFFFFFu;
}
